"""The bf16 forward of the attention kernels at the shapes `chip_smoke.py`
phase 2 runs them, timed at the launcher on one NVIDIA GPU (written for the
H100), for comparing two checkouts in turns: the streaming kernels (K2, K4,
K5) and, with --windowed, the windowed ones (K1, K6), at ViT-B's head dim;
with --d80 the four kernels of ViT-H (head dim 80) at batch 1 and 4 and
ragged.

    python3 scripts/time_streaming_forward.py [--root CHECKOUT] [--label L]
        [--main] [--no-tables] [--windowed] [--d80]

`--root` is the checkout whose `wildlifemapper_tpu_torch` is imported (this
script's own by default), so that one call can time an older tree with the
same script: run it as parent / change / change / parent. Only the launcher
that every tree of the port has is used (`attention_launch`), so the
forward is whatever body that tree runs. Each shape is checked against the
plain version (out at 2e-2, as phase 2 holds it, and the lse at 2e-2), run
twice with the lse (bit-identical), warmed up and timed over 20 (ITERS)
launches with the lse, as training runs it, and without, as
serving does: `ms` by CUDA events around the launches, `device_ms` the
kernel's own time under torch.profiler (at the small shapes the host's
launcher is slower than the kernel, and the events time the host). Beside
them one `scaled_dot_product_attention` call on the same inputs (the bias
as attn_mask; a yardstick, used nowhere in the port) and the bound: the
larger of the flops (4*B*H*N*M*d) over 989 TFLOP/s and the bytes (q, k, v,
the tables, out) over 3.35 TB/s. `--main` keeps the main paths' six shapes
(N 4096 and 2304) and drops the ragged ones; `--no-tables` runs K2 and K5
without their rel tables, the same attention without the bias, so that
the difference is what the bias costs. --windowed adds K1 and K6 at
ViT-B's windows, --d80 runs ViT-H's shapes instead of ViT-B's (with
--windowed, only the d-80 windows; with --main, the d-80 rows at batch 1
and 4). One JSON line a shape, the card's name and power limit first.
Fails without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

PEAK_FLOPS = 989e12   # H100 SXM, bf16 dense
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
ITERS = 20            # launches a timing: the kernels take 0.02-0.6 ms

# kernel, shape, batch (B, BW, BH or BWH), heads, head dim, queries, keys,
# rel grid
SHAPES = [
    ("K2", "B=4 N=4096", 4, 12, 64, 4096, 4096, (64, 64)),
    ("K5", "BH=4*12 N=4096", 48, 1, 64, 4096, 4096, (64, 64)),
    ("K4", "B=4 N=M=4096", 4, 8, 128, 4096, 4096, None),
    ("K2", "B=4 N=2304", 4, 12, 64, 2304, 2304, (48, 48)),
    ("K5", "BH=4*12 N=2304", 48, 1, 64, 2304, 2304, (48, 48)),
    ("K4", "B=4 N=M=2304", 4, 8, 128, 2304, 2304, None),
    ("K5", "BH=8 N=2304 d=128", 8, 1, 128, 2304, 2304, (48, 48)),
    ("K2", "B=2 H=3 N=1000 (25x40)", 2, 3, 64, 1000, 1000, (25, 40)),
    ("K5", "BH=6 N=1000 (20x50)", 6, 1, 64, 1000, 1000, (20, 50)),
    ("K5", "BH=4 N=513 (27x19) d=128", 4, 1, 128, 513, 513, (27, 19)),
    ("K4", "B=2 N=200 M=1000", 2, 8, 128, 200, 1000, None),
    ("K4", "B=1 N=300 M=1030", 1, 8, 128, 300, 1030, None),
]
WINDOWED = [
    ("K1", "BW=4*25 N=196", 100, 12, 64, 196, 196, (14, 14)),
    ("K6", "BWH=4*25*12 N=196", 1200, 1, 64, 196, 196, (14, 14)),
    ("K1", "BW=4*16 N=144", 64, 12, 64, 144, 144, (12, 12)),
    ("K6", "BWH=4*16*12 N=144", 768, 1, 64, 144, 144, (12, 12)),
]
# ViT-H: 16 heads of 80, the 64-grid and windows of 14, batch 1 and 4; then
# ragged against the Hopper and the resident bodies
D80 = [
    ("K2", "B=1 H=16 N=4096 d=80", 1, 16, 80, 4096, 4096, (64, 64)),
    ("K5", "BH=16 N=4096 d=80", 16, 1, 80, 4096, 4096, (64, 64)),
    ("K2", "B=4 H=16 N=4096 d=80", 4, 16, 80, 4096, 4096, (64, 64)),
    ("K5", "BH=64 N=4096 d=80", 64, 1, 80, 4096, 4096, (64, 64)),
    ("K2", "B=2 H=3 N=1000 (25x40) d=80", 2, 3, 80, 1000, 1000, (25, 40)),
    ("K5", "BH=6 N=1000 (20x50) d=80", 6, 1, 80, 1000, 1000, (20, 50)),
]
D80_WINDOWED = [
    ("K1", "BW=25 H=16 N=196 d=80", 25, 16, 80, 196, 196, (14, 14)),
    ("K6", "BWH=25*16 N=196 d=80", 400, 1, 80, 196, 196, (14, 14)),
    ("K1", "BW=100 H=16 N=196 d=80", 100, 16, 80, 196, 196, (14, 14)),
    ("K6", "BWH=100*16 N=196 d=80", 1600, 1, 80, 196, 196, (14, 14)),
    ("K1", "BW=3 H=3 N=49 (7x7) d=80", 3, 3, 80, 49, 49, (7, 7)),
    ("K6", "BWH=10 N=100 (10x10) d=80", 10, 1, 80, 100, 100, (10, 10)),
]


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def device_ms(fn) -> float:
    """The device's busy time a call: every kernel's time under
    torch.profiler, summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1000 / ITERS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package is timed")
    ap.add_argument("--label", default="", help="names the run in the output")
    ap.add_argument("--main", action="store_true",
                    help="only the main paths' shapes")
    ap.add_argument("--no-tables", action="store_true",
                    help="K2 and K5 without their rel tables")
    ap.add_argument("--windowed", action="store_true",
                    help="also K1 and K6 (with --d80: only them)")
    ap.add_argument("--d80", action="store_true",
                    help="ViT-H's shapes (head dim 80) in place of ViT-B's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch.nn.functional as F
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

    if args.d80:
        shapes = (D80_WINDOWED if args.windowed else D80 + D80_WINDOWED)
        if args.main:
            shapes = [c for c in shapes if "x" not in c[1].split("d=")[0]]
    else:
        shapes = (SHAPES[:6] if args.main else SHAPES) + (
            WINDOWED if args.windowed else [])
    with torch.no_grad():
        for kid, shape, b, h, d, nq, nk, hw in shapes:
            ss = kid in ("K5", "K6")
            c = h * d
            q = randn((b, nq, c))
            k, v = randn((b, nk, c)), randn((b, nk, c))
            rh = rw = None
            if hw and args.no_tables:
                hw = None
            if hw:
                rh = randn((b, nq, h, hw[0]), 0.5)
                rw = randn((b, nq, h, hw[1]), 0.5)
            scale = d ** -0.5

            def forward(lse=True):
                return A.attention_launch(q, k, v, scale, h, rh, rw,
                                          return_lse=lse, scale_scores=ss)

            ref, lse_ref = A.attention_plain(
                q.float(), k.float(), v.float(), scale, h,
                None if rh is None else rh.float(),
                None if rw is None else rw.float(), return_lse=True,
                scale_scores=ss)
            (out, lse), (out2, lse2) = forward(), forward()
            err = (out.float() - ref).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            ok = (bool(torch.isclose(out.float(), ref, atol=2e-2,
                                     rtol=2e-2).all())
                  and bool(torch.isclose(lse, lse_ref, atol=2e-2,
                                         rtol=2e-2).all()))
            same = torch.equal(out, out2) and torch.equal(lse, lse2)
            del ref, lse_ref, out2, lse2
            qh, kh, vh = (t.view(b, t.shape[1], h, d).transpose(1, 2)
                          for t in (q, k, v))
            bias = None
            if hw:
                bias = (rh.permute(0, 2, 1, 3)[..., :, None]
                        + rw.permute(0, 2, 1, 3)[..., None, :]
                        ).reshape(b, h, nq, nk).contiguous()
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias, scale=scale))
            del bias
            flops = 4 * b * h * nq * nk * d
            nbytes = sum(t.numel() * 2 for t in (q, k, v, out, rh, rw)
                         if t is not None)
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = dict(kernel=kid, shape=shape, label=args.label,
                       tables=rh is not None,
                       body=A.attention_body(dt, d, nq, nk, hw is not None,
                                             hw),
                       max_abs_err=err, lse_max_abs_err=lse_err,
                       within_tolerance=ok, bit_identical_twice=same,
                       ms=time_ms(forward),
                       device_ms=device_ms(forward),
                       ms_without_lse=time_ms(lambda: forward(False)),
                       library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       gpu=gpu)
            print(json.dumps(row), flush=True)
            if not (ok and same):
                raise AssertionError(f"{kid} {shape}: {row}")
            del q, k, v, out, lse, rh, rw
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
