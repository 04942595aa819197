"""Variants of the f32 windows' bodies (K1, K6), the backward
(csrc/attention_bwd_f32_window.cuh) or, with `--forward`, the forward
(csrc/attention_fwd_f32_window.cuh), timed on one NVIDIA GPU (written for the
H100) at the main paths' window shapes:

    python3 scripts/sweep_f32_window.py [--forward] [--variants body,...]
        [--turns N] [--tables full|no_drel|none] [--shapes 0,1,...]

A variant is the header with the edits VARIANTS (FORWARD_VARIANTS) names
("body": none, the header as the port builds it). The backward's: one block
a window-head running both passes, 8 rows a thread at 161 to 196 tokens, the
score products' column loop unrolled once, four times or fully. The
forward's: one block a window-head at every size (the body takes two where
two blocks fit an SM), 8 rows a thread at 161 to 196 tokens, the p tile's
rows padded by 4 floats instead of 16. Each variant's header is
built with copies of the body's two sources (attention_bwd_f32_window.cu and
grouped_attention_bwd_f32_window.cu, or their _fwd_ counterparts) under
build/sweep_f32_window/<variant>/ (the forward's under
build/sweep_f32_window_forward/) by scripts/sweep_build.py; every edit must
match the header once. At every shape each variant is run once and held to
the plain version (ops/_attention.py::attention_backward_plain at the f32
gradient tolerance, 5e-4 / 1e-3; attention_plain, out and lse, at 2e-5 /
1e-4), then timed in N turns by CUDA events over 10 launches, the variants in
turn. `--tables no_drel` passes the rel tables without their gradients, `none`
no tables at all (what the tables cost; the backward's outputs are then not
compared; the forward takes `full` or `none`). One JSON line a variant (ptxas
registers and spills of each instantiation) and a shape (each variant's best
turn in ms), the card's name and power limit first. Fails without CUDA.
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
FAMILIES = {False: "attention_bwd_f32_window",
            True: "grouped_attention_bwd_f32_window"}
HEADER = "attention_bwd_f32_window.cuh"
SCORE_LOOP = "#pragma unroll 2\n  for (int c = 0; c < D; c += 4) {"


def _unroll(n: str) -> list:
    return [(SCORE_LOOP, SCORE_LOOP.replace("unroll 2", n))]


# name -> [(text of the header, its replacement)]
VARIANTS = {
    "body": [],
    "one_block": [
        ("const bool pass1 = blockIdx.x % 2 == 0;\n  const int wh = blockIdx.x / 2;",
         "const bool pass1 = true;\n  const int wh = blockIdx.x;"),
        ("    return;\n  }\n\n  // ---- pass 2",
         "  }\n  __syncthreads();\n\n  // ---- pass 2"),
        ("(long long)batch * a.heads * 2;", "(long long)batch * a.heads;")],
    "rows8": [("  if (n <= 196) return launch_f32_window<D, 7, 7, SCALE_SCORES>"
               "(a, batch, stream);\n", "")],
    "unroll1": _unroll("unroll 1"),
    "unroll4": _unroll("unroll 4"),
    "unroll_full": _unroll("unroll"),
}
FORWARD_FAMILIES = {False: "attention_fwd_f32_window",
                    True: "grouped_attention_fwd_f32_window"}
FORWARD_HEADER = "attention_fwd_f32_window.cuh"
FORWARD_LAUNCH = """\
  if (a.n <= 160) return launch_f32_window_fwd<D, 3, 8, 2, SCALE_SCORES>(a, batch, stream);
  if constexpr (D == 64) {
    if (a.n <= 196) return launch_f32_window_fwd<D, 4, 7, 2, SCALE_SCORES>(a, batch, stream);
    return launch_f32_window_fwd<D, 4, 8, 2, SCALE_SCORES>(a, batch, stream);
  } else {
    if (a.n <= 196) return launch_f32_window_fwd<D, 7, 7, 1, SCALE_SCORES>(a, batch, stream);
    return launch_f32_window_fwd<D, 7, 8, 1, SCALE_SCORES>(a, batch, stream);
  }
"""
FORWARD_VARIANTS = {
    "body": [],
    # one block a window-head at every size: 5 warps of 32 rows up to 160
    # tokens, 7 of 28 up to 196, 7 of 32 up to 224
    "one_block": [(FORWARD_LAUNCH, """\
  if (a.n <= 160) return launch_f32_window_fwd<D, 5, 8, 1, SCALE_SCORES>(a, batch, stream);
  if (a.n <= 196) return launch_f32_window_fwd<D, 7, 7, 1, SCALE_SCORES>(a, batch, stream);
  return launch_f32_window_fwd<D, 7, 8, 1, SCALE_SCORES>(a, batch, stream);
""")],
    # 8 rows a thread at 161 to 196 tokens
    "rows8": [(FORWARD_LAUNCH, "".join(
        line + "\n" for line in FORWARD_LAUNCH.splitlines()
        if "a.n <= 196" not in line))],
    "pad4": [("constexpr int kFwfLdPad = 16;", "constexpr int kFwfLdPad = 4;")],
}
# label, grouped (K6), windows (or window-heads), heads, head dim, grid
SHAPES = [("K1 BW=4*25 N=196", False, 100, 12, 64, (14, 14)),
          ("K6 BWH=4*25*12 N=196", True, 1200, 1, 64, (14, 14)),
          ("K1 BW=4*16 N=144", False, 64, 12, 64, (12, 12)),
          ("K6 BWH=4*16*12 N=144", True, 768, 1, 64, (12, 12)),
          ("K1 BW=4*25 H=16 N=196 d=80", False, 100, 16, 80, (14, 14)),
          ("K1 BW=4*16 H=16 N=144 d=80", False, 64, 16, 80, (12, 12)),
          ("K1 BW=25 H=16 N=196 d=80", False, 25, 16, 80, (14, 14))]
ITERS = 10


def launch_forward(fn, q, k, v, scale, heads, rh, rw, out, lse):
    """One launch of a forward variant's C entry, with the port's
    arguments (ops/_attention.py::attention_launch's)."""
    from wildlifemapper_tpu_torch.ops import _build

    b, n, _ = q.shape
    gh, gw = (rh.shape[-1], rw.shape[-1]) if rh is not None else (0, 0)
    err = fn(_build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), *(t.data_ptr() if t is not None else None
                               for t in (rh, rw, lse)),
             b, heads, n, k.shape[1], q.shape[-1] // heads,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), out.stride(0), out.stride(1),
             gh, gw, float(scale), _build.stream_ptr(q))
    if err:
        raise RuntimeError(f"launch failed with cudaError_t {err}")


def launch(fn, q, k, v, out, lse, dout, scale, heads, rh, rw, grads):
    """One launch of a variant's C entry, with the port's arguments."""
    from wildlifemapper_tpu_torch.ops._attention import window_backward_args

    gh, gw = (rh.shape[-1], rw.shape[-1]) if rh is not None else (0, 0)
    err = fn(*window_backward_args(q, k, v, dout, out, lse, rh, rw, *grads,
                                   scale, heads, q.shape[-1] // heads, gh,
                                   gw))
    if err:
        raise RuntimeError(f"launch failed with cudaError_t {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forward", action="store_true",
                    help="the forward's variants (FORWARD_VARIANTS)")
    ap.add_argument("--variants", default=None,
                    help="names of VARIANTS (FORWARD_VARIANTS), all by "
                         "default")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--tables", choices=("full", "no_drel", "none"),
                    default="full")
    ap.add_argument("--shapes", default=",".join(
        str(i) for i in range(len(SHAPES))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_plain, attention_launch, attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    forward = args.forward
    if forward and args.tables == "no_drel":
        ap.error("the forward takes --tables full or none")
    table = FORWARD_VARIANTS if forward else VARIANTS
    families = FORWARD_FAMILIES if forward else FAMILIES
    print(json.dumps(dict(gpu=gpu, tables=args.tables,
                          direction="forward" if forward else "backward")),
          flush=True)
    variants = (args.variants or ",".join(table)).split(",")
    entries = sweep_build.build(
        "sweep_f32_window" + ("_forward" if forward else ""),
        {name: (FORWARD_HEADER if forward else HEADER, table[name],
                list(families.values())) for name in variants},
        "attn_fwd_f32_window_kernel" if forward
        else "attn_bwd_f32_window_kernel")
    for name in variants:
        print(json.dumps(dict(variant=name, edits=len(table[name]),
                              ptxas=[line for src in families.values()
                                     for line in entries[name, src][1]])),
              flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in map(int, args.shapes.split(",")):
        label, grouped, b, heads, d, hw = SHAPES[i]
        n, c, scale = hw[0] * hw[1], heads * d, d ** -0.5
        q, k, v, dout = (torch.randn(b, n, c, device=dev, generator=gen)
                         for _ in range(4))
        rh = torch.randn(b, n, heads, hw[0], device=dev, generator=gen) * 0.5
        rw = torch.randn(b, n, heads, hw[1], device=dev, generator=gen) * 0.5
        tabs = (rh, rw) if args.tables != "none" else (None, None)
        with torch.no_grad():
            if forward:
                want = attention_plain(q, k, v, scale, heads, *tabs,
                                       return_lse=True, scale_scores=grouped)
            else:
                out, lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                            return_lse=True,
                                            scale_scores=grouped)
                want = attention_backward_plain(q, k, v, out, lse, dout,
                                                scale, heads, rh, rw,
                                                scale_scores=grouped)
        runs, errs = {}, {}
        for name in variants:
            fn = entries[name, families[grouped]][0]
            if forward:
                got = (torch.empty_like(q),
                       torch.empty(b, n, heads, device=dev))
                runs[name] = (lambda fn=fn, got=got: launch_forward(
                    fn, q, k, v, scale, heads, *tabs, *got))
                runs[name]()
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-4,
                                               msg=f"{name} at {label}")
                errs[name] = max((g - w).abs().max().item()
                                 for g, w in zip(got, want))
                continue
            grads = [torch.empty_like(t) for t in (q, k, v)] + (
                [torch.empty_like(rh), torch.empty_like(rw)]
                if args.tables == "full" else [None, None])
            runs[name] = (lambda fn=fn, grads=grads: launch(
                fn, q, k, v, out, lse, dout, scale, heads, *tabs, grads))
            runs[name]()
            torch.cuda.synchronize()
            if args.tables != "none":
                pairs = [(g, w) for g, w in zip(grads, want) if g is not None]
                for g, w in pairs:
                    torch.testing.assert_close(g, w, atol=5e-4, rtol=1e-3,
                                               msg=f"{name} at {label}")
                errs[name] = max((g - w).abs().max().item()
                                 for g, w in pairs)
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
        print(json.dumps(dict(shape=label, tables=args.tables, ms=best,
                              max_abs_err=errs)), flush=True)
        del q, k, v, dout, rh, rw, want, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
