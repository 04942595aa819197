"""Variants of the f32 attention bodies (csrc/attention_fwd_f32.cuh, the
forward of K2 / K5 at head dim 64 and 80 with the rel tables and of K4 at
128; csrc/attention_bwd_f32_d128.cuh, K4's backward), timed on one NVIDIA
GPU (written for the H100) at K2's and K4's shapes:

    python3 scripts/sweep_f32_attention.py [--variants body,keys64,...]
        [--turns N] [--shapes 0,1,...]

A variant is a header with the edits VARIANTS names ("body": none, the
headers as the port builds them): the forward on 64- or 96-key tiles (K4's
too; timed at d 64 and 80), on one stage or two at d 64 and 80 (the next
tile's copy under this tile's products; 128-key tiles on two stages do not
fit beside the tables), with p strips 16 or 64 keys deep; P.V's loop over a
strip unrolled fully; K4's forward with p in strips of its own as d 64 and
80 have it (K's next tile copied under P.V); the forward's score loop
unrolled twice, eight times or fully; the backward's score loops unrolled
twice or eight times, its dq kernel on two or four stages. Each variant's
header is built with a copy of its source (attention_fwd_f32.cu or
attention_bwd_f32_d128.cu) under build/sweep_f32_attention/<variant>/ by
scripts/sweep_build.py; every edit must match the header once. A variant
runs at the shapes of the head dims it changes. At every shape each
variant is run once and held to the plain version
(ops/_attention.py::attention_plain at 2e-5 / 1e-4, attention_backward_plain
at 5e-4 / 1e-3), then timed in N turns by CUDA events over 5 launches, the
variants in turn (a forward variant's forward, a backward variant's whole
backward); a variant whose shared memory does not fit a shape's tables is
refused by its launch and reported as null. One JSON line a variant (ptxas
registers and spills of each kernel) and a shape (each variant's best turn
in ms), the card's name and power limit first. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import sweep_build

ROOT = Path(__file__).resolve().parents[1]
FORWARD, BACKWARD = "attention_fwd_f32", "attention_bwd_f32_d128"
FWD_SCORES = "#pragma unroll 4\n  for (int c = 0; c < D; c += 4) {"
BWD_SCORES = "#pragma unroll 4\n  for (int c = 0; c < D; c += 4) {"
FWD_PV = "#pragma unroll 4\n  for (int j = 0; j < J; ++j) {"
TILES = "constexpr int kFfKeys = 128;"
# the forward at d 64 and 80 on two stages of K and V tiles: the next tile's
# copy issued under this tile's products, one barrier a tile less
STAGES2 = [
    ("  return 4 * (D * kFfRows + 2 * BK * (D + 4) +",
     "  return 4 * (D * kFfRows + (ff_p_own<D>() ? 4 : 2) * BK * (D + 4) +"),
    ("  float* pw = vs + BK * LDT; ",
     "  float* pw = vs + (OWN ? 3 : 1) * BK * LDT; "),
    ("""    fb_wait<1>();     // K of tile kt
    __syncthreads();

    // s = (q*scale) . k over c = 0 .. D-1 in order
    float s[8][NJ];
    ff_scores<D, NJ>(s, qt, rA, ks, kl);""",
     """    float* kst = ks + (OWN ? (kt & 1) * 2 * BK * LDT : 0);
    float* vst = kst + BK * LDT;
    if constexpr (OWN) {
      float* nxt = ks + ((kt + 1) & 1) * 2 * BK * LDT;
      load(nxt, kg, a.k_rs, kt + 1);
      load(nxt + BK * LDT, vg, a.v_rs, kt + 1);
      fb_wait<2>();
    } else {
      fb_wait<1>();
    }
    __syncthreads();

    // s = (q*scale) . k over c = 0 .. D-1 in order
    float s[8][NJ];
    ff_scores<D, NJ>(s, qt, rA, kst, kl);"""),
    ("""      fb_wait<0>();     // V of tile kt
      __syncthreads();  // every warp is past the scores: K's tile is free
      load(ks, kg, a.k_rs, kt + 1);
""", ""),
    ("vs + cnk * kFfPKeys * LDT", "vst + cnk * kFfPKeys * LDT"),
    ("""      __syncthreads();    // V's tile is read
      load(vs, vg, a.v_rs, kt + 1);
""", """      __syncthreads();    // the stage's tiles are read
"""),
]


def _unroll(loop: str, n: str) -> list:
    return [(loop, loop.replace("unroll 4", n))]


def _tiles(keys: int, stages: int) -> list:
    """The forward's key tile (K4's too) and, at d 64 and 80, two stages."""
    return ([(TILES, TILES.replace("128", str(keys)))]
            + (STAGES2 if stages == 2 else []))


# name -> (source, [(text of the header, its replacement)], head dims run)
VARIANTS = {
    "body": (FORWARD, [], (64, 80, 128)),
    "keys64": (FORWARD, _tiles(64, 1), (64, 80)),
    "keys96": (FORWARD, _tiles(96, 1), (64, 80)),
    "keys64_stages2": (FORWARD, _tiles(64, 2), (64, 80)),
    "keys96_stages2": (FORWARD, _tiles(96, 2), (64, 80)),
    # the p strips 16 or 64 keys deep (64 leaves no room for the 64-grid's
    # tables at d 80), P.V's loop over a strip unrolled fully
    "pkeys16": (FORWARD, [("kFfPKeys = 32;", "kFfPKeys = 16;")], (64, 80)),
    "pkeys64": (FORWARD, [("kFfPKeys = 32;", "kFfPKeys = 64;")], (64, 80)),
    "pv_unroll_full": (FORWARD, [(FWD_PV, FWD_PV.replace(
        "unroll 4", "unroll(J <= 64 ? J : 4)"))], (64, 80, 128)),
    # K4's forward with p in strips of its own, K's next tile under P.V
    "k4_p_strips": (FORWARD, [("return D + 4 < kFfRows + 4;",
                               "return true;")], (128,)),
    "fwd_unroll2": (FORWARD, _unroll(FWD_SCORES, "unroll 2"), (64, 80, 128)),
    "fwd_unroll8": (FORWARD, _unroll(FWD_SCORES, "unroll 8"), (64, 80, 128)),
    "fwd_unroll_full": (FORWARD, _unroll(FWD_SCORES, "unroll"),
                        (64, 80, 128)),
    "bwd_body": (BACKWARD, [], (128,)),
    "bwd_unroll2": (BACKWARD, _unroll(BWD_SCORES, "unroll 2"), (128,)),
    "bwd_unroll8": (BACKWARD, _unroll(BWD_SCORES, "unroll 8"), (128,)),
    "dq_stages2": (BACKWARD, [("constexpr int kFdStages = 3;",
                               "constexpr int kFdStages = 2;"),
                              ("fd_dq_smem<128>() == 98304",
                               "fd_dq_smem<128>() == 65536")], (128,)),
    "dq_stages4": (BACKWARD, [("constexpr int kFdStages = 3;",
                               "constexpr int kFdStages = 4;"),
                              ("fd_dq_smem<128>() == 98304",
                               "fd_dq_smem<128>() == 131072")], (128,)),
}
# label, batch, heads, queries, keys, head dim, rel grid: K2 at the full
# canvas and on the 48-grid, ViT-H's d 80 at batch 1 (full canvas) and 4
# (from scratch); K4 at the full canvas and on the 48-grid, a
# tensor-parallel rank's 4 heads
SHAPES = [("K2 B=4 N=4096 d=64", 4, 12, 4096, 4096, 64, (64, 64)),
          ("K2 B=4 N=2304 d=64", 4, 12, 2304, 2304, 64, (48, 48)),
          ("K2 B=1 H=16 N=4096 d=80", 1, 16, 4096, 4096, 80, (64, 64)),
          ("K2 B=4 H=16 N=2304 d=80", 4, 16, 2304, 2304, 80, (48, 48)),
          ("K4 B=4 N=M=4096", 4, 8, 4096, 4096, 128, None),
          ("K4 B=4 N=M=2304", 4, 8, 2304, 2304, 128, None),
          ("K4 B=4 H=4 N=M=2304 (TP rank)", 4, 4, 2304, 2304, 128, None)]
ITERS = 5


def forward(fn, q, k, v, rh, rw, scale, heads, out, lse):
    """One launch of a forward variant's C entry, with the port's
    arguments; raises if the launch is refused."""
    from wildlifemapper_tpu_torch.ops import _build

    b, n, c = q.shape
    gh, gw = (rh.shape[-1], rw.shape[-1]) if rh is not None else (0, 0)
    err = fn(_build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), None if rh is None else rh.data_ptr(),
             None if rw is None else rw.data_ptr(), lse.data_ptr(), b, heads,
             n, k.shape[1], c // heads, q.stride(0), q.stride(1),
             k.stride(0), k.stride(1), v.stride(0), v.stride(1),
             out.stride(0), out.stride(1), gh, gw, float(scale),
             _build.stream_ptr(q))
    if err:
        raise RuntimeError(f"launch failed with cudaError_t {err}")


def backward(fn, q, k, v, out, lse, dout, scale, heads, grads, scratch):
    """A backward variant's two launches (delta and dk/dv, then dq), with
    the port's arguments."""
    from wildlifemapper_tpu_torch.ops import _attention

    lib = type("Lib", (), {"wm_attention_bwd_f32_d128": fn})
    real = _attention._build.load_kernels
    _attention._build.load_kernels = lambda: lib
    try:
        for kernel in (0, 1):
            _attention._f32_d128_backward_launch(
                kernel, q, k, v, dout, out, lse, scratch, *grads, scale,
                heads)
    finally:
        _attention._build.load_kernels = real


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--shapes", default=",".join(
        str(i) for i in range(len(SHAPES))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_plain, attention_launch, attention_plain,
        f32_d128_scratch)

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(gpu=gpu)), flush=True)
    variants = args.variants.split(",")
    entries = sweep_build.build(
        "sweep_f32_attention",
        {name: (src + ".cuh", edits, [src])
         for name, (src, edits, _) in ((n, VARIANTS[n]) for n in variants)},
        r"attn_(?:fwd|bwd)_f32\w*?_kernel")
    entries = {name: entries[name, VARIANTS[name][0]] for name in variants}
    for name in variants:
        print(json.dumps(dict(variant=name, source=VARIANTS[name][0],
                              edits=len(VARIANTS[name][1]),
                              ptxas=entries[name][1])), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in map(int, args.shapes.split(",")):
        label, b, heads, n, m, d, hw = SHAPES[i]
        names = [name for name in variants if d in VARIANTS[name][2]]
        c, scale = heads * d, d ** -0.5
        q, dout = (torch.randn(b, n, c, device=dev, generator=gen)
                   for _ in range(2))
        k, v = (torch.randn(b, m, c, device=dev, generator=gen)
                for _ in range(2))
        rh = rw = None
        if hw:
            rh, rw = (0.5 * torch.randn(b, n, heads, g, device=dev,
                                        generator=gen) for g in hw)
        with torch.no_grad():
            out, lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                        return_lse=True)
            want_out = attention_plain(q, k, v, scale, heads, rh, rw)
            want = (attention_backward_plain(q, k, v, out, lse, dout, scale,
                                             heads)[:3] if d == 128 else None)
        runs, errs = {}, {}
        for name in names:
            fn = entries[name][0]
            if VARIANTS[name][0] == FORWARD:
                bufs = (torch.empty_like(q), torch.empty_like(lse))

                def run(fn=fn, bufs=bufs):
                    forward(fn, q, k, v, rh, rw, scale, heads, *bufs)
                try:
                    run()
                except RuntimeError:
                    errs[name] = None       # refused: no room for the tables
                    continue
                got, ref, tol = [bufs[0]], [want_out], (2e-5, 1e-4)
            else:
                grads = [torch.empty_like(t) for t in (q, k, v)]
                scratch = f32_d128_scratch(q, k, heads)

                def run(fn=fn, grads=grads, scratch=scratch):
                    backward(fn, q, k, v, out, lse, dout, scale, heads, grads,
                             scratch)
                run()
                got, ref, tol = grads, want, (5e-4, 1e-3)
            torch.cuda.synchronize()
            for g, w in zip(got, ref):
                torch.testing.assert_close(g, w, atol=tol[0], rtol=tol[1],
                                           msg=f"{name} at {label}")
            errs[name] = max((g - w).abs().max().item()
                             for g, w in zip(got, ref))
            runs[name] = run
        best = {name: None if name not in runs else float("inf")
                for name in names}
        for _ in range(args.turns):
            for name, run in runs.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(ITERS):
                    run()
                end.record()
                torch.cuda.synchronize()
                best[name] = min(best[name], start.elapsed_time(end) / ITERS)
        print(json.dumps(dict(shape=label, ms=best, max_abs_err=errs)),
              flush=True)
        del q, k, v, rh, rw, dout, out, lse, want, want_out, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
