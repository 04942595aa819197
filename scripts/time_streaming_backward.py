"""The whole bf16 backward of the streaming attention kernels (K2, K4, K5) at
the shapes `chip_smoke.py` phase 6 runs them, or of the windowed ones (K1,
K6), timed at the launcher on one NVIDIA GPU (written for the H100), for
comparing two checkouts in turns.

    python3 scripts/time_streaming_backward.py [--root CHECKOUT] [--label L]
        [--d80 | --windowed]

`--root` is the checkout whose `wildlifemapper_tpu_torch` is imported (this
script's own by default), so that one call can time an older tree with the
same script: run it as parent / change / change / parent. Only the launcher
that every tree of the port has is used (`attention_launch`,
`attention_backward_launch`), so the backward is whatever that tree runs:
for the first Hopper body a plain delta pass and two kernels, for its
redesign two kernels with delta inside the first. Each shape, with the rel
tables' gradients and (where there are tables) without, is warmed up and
timed over ten launches after a check against the plain backward (2e-2 of
each gradient's largest element): `ms` by CUDA events around the launches,
`device_ms` the kernels' own time under torch.profiler (where the host's
launcher is slower than the kernels, `ms` times the host). One JSON line a
shape, the card's name and power limit first. `--d80` runs ViT-H's shapes
instead (head dim 80: K2 and K5 at batch 1 and 4 on the 64-grid, on the
48-grid and ragged), which an older tree runs on the tile bodies.
`--windowed` runs K1 and K6 on windows of 14 instead: at head dim 80
(ViT-H, 16 heads) at batch 1 and 4 (25 and 100 windows), which an older tree
runs on the tile bodies (a plain delta pass and two kernels), and at head
dim 64 (ViT-B, 12 heads) at N 196 and 144 as the main paths give them at
batch 4. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# kernel, shape, batch (B or BH), heads, head dim, queries, keys, rel grid
SHAPES = [
    ("K2", "B=4 N=4096", 4, 12, 64, 4096, 4096, (64, 64)),
    ("K2", "B=4 N=2304", 4, 12, 64, 2304, 2304, (48, 48)),
    ("K2", "B=2 H=3 N=1000 (25x40)", 2, 3, 64, 1000, 1000, (25, 40)),
    ("K4", "B=4 N=M=4096", 4, 8, 128, 4096, 4096, None),
    ("K4", "B=4 N=M=2304", 4, 8, 128, 2304, 2304, None),
    ("K4", "B=2 N=200 M=1000", 2, 8, 128, 200, 1000, None),
    ("K4", "B=1 N=1030 M=577", 1, 8, 128, 1030, 577, None),
    ("K5", "BH=4*12 N=4096", 48, 1, 64, 4096, 4096, (64, 64)),
    ("K5", "BH=4*12 N=2304", 48, 1, 64, 2304, 2304, (48, 48)),
    ("K5", "BH=6 N=1000 (20x50)", 6, 1, 64, 1000, 1000, (20, 50)),
]
SHAPES_D80 = [
    ("K2", "B=1 H=16 N=4096 d=80", 1, 16, 80, 4096, 4096, (64, 64)),
    ("K2", "B=4 H=16 N=4096 d=80", 4, 16, 80, 4096, 4096, (64, 64)),
    ("K5", "BH=16 N=4096 d=80", 16, 1, 80, 4096, 4096, (64, 64)),
    ("K5", "BH=64 N=4096 d=80", 64, 1, 80, 4096, 4096, (64, 64)),
    ("K2", "B=1 H=16 N=2304 d=80", 1, 16, 80, 2304, 2304, (48, 48)),
    ("K2", "B=2 H=3 N=1000 d=80 (25x40)", 2, 3, 80, 1000, 1000, (25, 40)),
    ("K5", "BH=6 N=1000 d=80 (20x50)", 6, 1, 80, 1000, 1000, (20, 50)),
]
SHAPES_WINDOWED = [
    ("K1", "BW=25 H=16 N=196 d=80", 25, 16, 80, 196, 196, (14, 14)),
    ("K1", "BW=100 H=16 N=196 d=80", 100, 16, 80, 196, 196, (14, 14)),
    ("K6", "BWH=400 N=196 d=80", 400, 1, 80, 196, 196, (14, 14)),
    ("K6", "BWH=1600 N=196 d=80", 1600, 1, 80, 196, 196, (14, 14)),
    ("K1", "BW=100 N=196", 100, 12, 64, 196, 196, (14, 14)),
    ("K1", "BW=64 N=144", 64, 12, 64, 144, 144, (12, 12)),
    ("K6", "BWH=1200 N=196", 1200, 1, 64, 196, 196, (14, 14)),
    ("K6", "BWH=768 N=144", 768, 1, 64, 144, 144, (12, 12)),
]


def time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """The device's busy time a call: every kernel's time under
    torch.profiler, summed. At the small shapes the host's launcher takes
    longer than the kernels, and the events above time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1000 / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package is timed")
    ap.add_argument("--label", default="", help="names the run in the output")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--d80", action="store_true",
                       help="ViT-H's shapes (head dim 80) instead of ViT-B's")
    which.add_argument("--windowed", action="store_true",
                       help="the windowed kernels (K1, K6) at d 80 and 64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from wildlifemapper_tpu_torch.ops import _attention as A

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(gpu=gpu, label=args.label, root=args.root,
                          package=A.__file__)), flush=True)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    dt = torch.bfloat16

    def randn(shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(size=shape,
                                                    dtype=np.float32) * s
                                ).to(dev).to(dt)

    with torch.no_grad():
        shapes = (SHAPES_D80 if args.d80 else
                  SHAPES_WINDOWED if args.windowed else SHAPES)
        for kid, shape, b, h, d, nq, nk, hw in shapes:
            ss = kid in ("K5", "K6")
            c = h * d
            q, dout = randn((b, nq, c)), randn((b, nq, c))
            k, v = randn((b, nk, c)), randn((b, nk, c))
            rh = rw = None
            if hw:
                rh = randn((b, nq, h, hw[0]), 0.5)
                rw = randn((b, nq, h, hw[1]), 0.5)
            scale = d ** -0.5
            out, lse = A.attention_launch(q, k, v, scale, h, rh, rw,
                                          return_lse=True, scale_scores=ss)
            ref = A.attention_backward_plain(q, k, v, out, lse, dout, scale,
                                             h, rh, rw, scale_scores=ss)
            got = A.attention_backward_launch(q, k, v, out, lse, dout, scale,
                                              h, rh, rw, scale_scores=ss)
            worst = max((g.float() - r.float()).abs().max().item()
                        / max(r.float().abs().max().item(), 1e-6)
                        for g, r in zip(got, ref) if r is not None)
            if worst > 2e-2:
                raise AssertionError(f"{kid} {shape}: backward off by {worst}")
            del ref, got
            row = dict(kernel=kid, shape=shape, label=args.label,
                       body=A.attention_body(dt, d, nq, nk, hw is not None,
                                             hw, "backward"),
                       max_rel_err=worst)
            for drel in ((True, False) if hw else (True,)):
                def backward():
                    A.attention_backward_launch(
                        q, k, v, out, lse, dout, scale, h, rh, rw,
                        want_drel=drel, scale_scores=ss)
                tail = "" if drel else "_without_drel"
                row["ms" + tail] = time_ms(backward)
                row["device_ms" + tail] = device_ms(backward)
            print(json.dumps(row), flush=True)
            del q, k, v, dout, out, lse, rh, rw
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
