"""Variants of K4's f32 bodies at head dim 128 (csrc/attention_fwd_f32.cuh,
the forward; csrc/attention_bwd_f32_d128.cuh, the backward), timed on one
NVIDIA GPU (written for the H100) at K4's shapes:

    python3 scripts/sweep_f32_attention.py [--variants body,keys64,...]
        [--turns N] [--shapes 0,1,...]

A variant is a header with the edits VARIANTS names ("body": none, the
headers as the port builds them): the forward on 64-, 80- or 96-key tiles
with p in a tile of its own and K's next tile copied under P.V, its score
loop unrolled twice, eight times or fully; the backward's score loops
unrolled twice or eight times, its dq kernel on two or four stages. Each
variant's header is built with a copy of its source (attention_fwd_f32.cu
or attention_bwd_f32_d128.cu) under build/sweep_f32_attention/<variant>/
by scripts/sweep_build.py; every edit must match the header once.
At every shape each variant is run once and held to the plain version
(ops/_attention.py::attention_plain at 2e-5 / 1e-4, attention_backward_plain
at 5e-4 / 1e-3), then timed in N turns by CUDA events over 5 launches, the
variants in turn (a forward variant's forward, a backward variant's whole
backward). One JSON line a variant (ptxas registers and spills of each
kernel) and a shape (each variant's best turn in ms), the card's name and
power limit first. Fails without CUDA.
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
FWD_SCORES = "#pragma unroll 4\n    for (int c = 0; c < D; c += 4) {"
BWD_SCORES = "#pragma unroll 4\n  for (int c = 0; c < D; c += 4) {"


def _unroll(loop: str, n: str) -> list:
    return [(loop, loop.replace("unroll 4", n))]


# the forward's p in a tile of its own beside K and V, K's next tile copied
# under P.V (the body writes p over K's tile and copies K after P.V)
P_OWN_TILE = [
    ("return 4 * (D * kFfRows + 2 * BK * (D + 4));",
     "return 4 * (D * kFfRows + 3 * BK * (D + 4));"),
    ("float* pt = ks; ", "float* pt = vs + BK * LDT; "),
    ("K's tile is free\n",
     "K's tile is free\n    load(ks, kg, a.k_rs, kt + 1);\n"),
    ("    load(ks, kg, a.k_rs, kt + 1);\n    load(vs, vg, a.v_rs, kt + 1);\n",
     "    load(vs, vg, a.v_rs, kt + 1);\n")]


# name -> (source, [(text of the header, its replacement)])
VARIANTS = {
    "body": (FORWARD, []),
    **{f"keys{n}": (FORWARD, [("constexpr int kFfKeys = 128;",
                               f"constexpr int kFfKeys = {n};"),
                              *P_OWN_TILE])
       for n in (64, 80, 96)},
    "fwd_unroll2": (FORWARD, _unroll(FWD_SCORES, "unroll 2")),
    "fwd_unroll8": (FORWARD, _unroll(FWD_SCORES, "unroll 8")),
    "fwd_unroll_full": (FORWARD, _unroll(FWD_SCORES, "unroll")),
    "bwd_body": (BACKWARD, []),
    "bwd_unroll2": (BACKWARD, _unroll(BWD_SCORES, "unroll 2")),
    "bwd_unroll8": (BACKWARD, _unroll(BWD_SCORES, "unroll 8")),
    "dq_stages2": (BACKWARD, [("constexpr int kFdStages = 3;",
                               "constexpr int kFdStages = 2;"),
                              ("fd_dq_smem<128>() == 98304",
                               "fd_dq_smem<128>() == 65536")]),
    "dq_stages4": (BACKWARD, [("constexpr int kFdStages = 3;",
                               "constexpr int kFdStages = 4;"),
                              ("fd_dq_smem<128>() == 98304",
                               "fd_dq_smem<128>() == 131072")]),
}
# label, batch, heads, queries, keys: K4 at the full canvas and on the
# 48-grid, a tensor-parallel rank's 4 heads
SHAPES = [("K4 B=4 N=M=4096", 4, 8, 4096, 4096),
          ("K4 B=4 N=M=2304", 4, 8, 2304, 2304),
          ("K4 B=4 H=4 N=M=2304 (TP rank)", 4, 4, 2304, 2304)]
ITERS = 5


def forward(fn, q, k, v, scale, heads, out, lse):
    """One launch of a forward variant's C entry, with the port's
    arguments."""
    from wildlifemapper_tpu_torch.ops import _build

    b, n, c = q.shape
    err = fn(_build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), None, None, lse.data_ptr(), b, heads, n,
             k.shape[1], c // heads, q.stride(0), q.stride(1), k.stride(0),
             k.stride(1), v.stride(0), v.stride(1), out.stride(0),
             out.stride(1), 0, 0, float(scale), _build.stream_ptr(q))
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
         for name, (src, edits) in ((n, VARIANTS[n]) for n in variants)},
        r"attn_(?:fwd|bwd)_f32\w*?_kernel")
    entries = {name: entries[name, VARIANTS[name][0]] for name in variants}
    for name in variants:
        print(json.dumps(dict(variant=name, source=VARIANTS[name][0],
                              edits=len(VARIANTS[name][1]),
                              ptxas=entries[name][1])), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in map(int, args.shapes.split(",")):
        label, b, heads, n, m = SHAPES[i]
        c, scale = heads * 128, 128 ** -0.5
        q, dout = (torch.randn(b, n, c, device=dev, generator=gen)
                   for _ in range(2))
        k, v = (torch.randn(b, m, c, device=dev, generator=gen)
                for _ in range(2))
        with torch.no_grad():
            out, lse = attention_launch(q, k, v, scale, heads,
                                        return_lse=True)
            want_out = attention_plain(q, k, v, scale, heads)
            want = attention_backward_plain(q, k, v, out, lse, dout, scale,
                                            heads)[:3]
        runs, errs = {}, {}
        for name in variants:
            fn = entries[name][0]
            if VARIANTS[name][0] == FORWARD:
                bufs = (torch.empty_like(q), torch.empty_like(lse))

                def run(fn=fn, bufs=bufs):
                    forward(fn, q, k, v, scale, heads, *bufs)
                run()
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
        best = {name: float("inf") for name in variants}
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
        del q, k, v, dout, out, lse, want, want_out, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
