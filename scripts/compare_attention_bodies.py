"""The bf16 bodies of the port's attention kernels side by side on one NVIDIA
GPU (written for the H100): "mma" (mma.sync tiles, csrc/attention_fwd.cuh and
attention_bwd.cuh) beside the body that `attention_body` gives the shape:
"sm90" (wgmma and a TMA-fed ring, csrc/attention_fwd_sm90.cuh and
attention_bwd_sm90.cuh) for the streaming shapes, "resident" (one block a
window-head, csrc/attention_fwd_resident.cuh and attention_bwd_resident.cuh)
for the windowed ones.

    python3 scripts/compare_attention_bodies.py             # every case
    python3 scripts/compare_attention_bodies.py --main      # main paths only
    python3 scripts/compare_attention_bodies.py --windowed  # windowed only
    python3 scripts/compare_attention_bodies.py --d80       # head dim 80 only

For each case (batch, heads, d, queries, keys, rel grid, scale placement,
scale) it builds the kernels (registers and spills of the Hopper and resident
instantiations are printed from nvcc's -Xptxas -v), runs forward and backward
of each body at the launcher (ops/_attention.py, `body=`; at head dim 80 as
at 64, a window takes the resident body both ways, beside the tile bodies),
and prints one JSON line: the largest forward and lse errors and the backward errors relative to
each gradient's largest element against the plain version, whether a second
backward is bit-identical, and CUDA-event times in ms, each body warmed up
and timed over five launches: forward, the whole backward (for the tile
bodies the delta pass included; the Hopper body's dq kernel takes delta
itself) with and without the rel-table gradients and, for the two-kernel
bodies, the delta pass, dq and dk/dv alone. The card's name and power limit
come first. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wildlifemapper_tpu_torch.ops import _attention as A  # noqa: E402
from wildlifemapper_tpu_torch.ops import _build  # noqa: E402

# batch, heads, d, queries, keys, rel grid, scale on the f32 scores, scale
# (None: d ** -0.5)
RAGGED = [
    (2, 2, 64, 128, 512, None, False, None),
    (2, 2, 128, 128, 512, None, True, None),
    (2, 2, 64, 128, 512, (8, 64), False, None),
    (2, 3, 64, 1000, 1000, (25, 40), False, None),
    (2, 3, 64, 1000, 1000, (20, 50), True, None),
    (1, 2, 128, 300, 1030, None, False, None),
    (2, 1, 128, 513, 513, (27, 19), True, None),
]
MAIN = [
    (4, 12, 64, 4096, 4096, (64, 64), False, None),    # K2, full canvas
    (48, 1, 64, 4096, 4096, (64, 64), True, None),     # K5
    (4, 12, 64, 2304, 2304, (48, 48), False, None),    # K2, 48-grid
    (48, 1, 64, 2304, 2304, (48, 48), True, None),     # K5
    (4, 8, 128, 4096, 4096, None, False, None),        # K4
    (4, 8, 128, 2304, 2304, None, False, None),
]
# ragged against the resident bodies' 16-row tiles and 144- / 208-row
# instantiations: odd table widths, one window-head, more window-heads than
# SMs by a few, a scale that is no power of two in either family
WINDOWED_RAGGED = [
    (3, 3, 64, 49, 49, (7, 7), False, None),
    (7, 1, 64, 49, 49, (7, 7), True, None),
    (5, 2, 64, 100, 100, (10, 10), False, None),
    (1, 1, 64, 196, 196, (14, 14), True, None),
    (1, 1, 64, 144, 144, (12, 12), False, None),
    (23, 6, 64, 196, 196, (14, 14), False, 0.3),
    (141, 1, 64, 144, 144, (12, 12), True, 0.3),
    (2, 2, 64, 208, 208, (13, 16), False, None),
    (2, 2, 64, 150, 150, (10, 15), True, None),
    (3, 1, 64, 6, 6, (2, 3), True, None),
]
# head dim 80 (ViT-H: 16 heads, the 64-grid and windows of 14) at batch 1 and
# ragged against the bodies' tiles
D80 = [
    (1, 16, 80, 4096, 4096, (64, 64), False, None),    # K2
    (16, 1, 80, 4096, 4096, (64, 64), True, None),     # K5
    (25, 16, 80, 196, 196, (14, 14), False, None),     # K1
    (400, 1, 80, 196, 196, (14, 14), True, None),      # K6
    (2, 3, 80, 1000, 1000, (25, 40), False, None),
    (6, 1, 80, 1000, 1000, (20, 50), True, None),
    (1, 2, 80, 2304, 2304, (48, 48), False, None),
    (1, 2, 80, 300, 1030, None, False, None),
    (3, 3, 80, 49, 49, (7, 7), False, None),
    (10, 1, 80, 100, 100, (10, 10), True, None),
    (2, 2, 80, 208, 208, (13, 16), False, None),
    (141, 1, 80, 144, 144, (12, 12), True, 0.3),
]
WINDOWED_MAIN = [
    (100, 12, 64, 196, 196, (14, 14), False, None),    # K1, full canvas
    (1200, 1, 64, 196, 196, (14, 14), True, None),     # K6
    (64, 12, 64, 144, 144, (12, 12), False, None),     # K1, 48-grid
    (768, 1, 64, 144, 144, (12, 12), True, None),      # K6
]


def time_ms(fn, iters: int = 5) -> float:
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


def hopper_ptxas(log: str) -> list:
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"(attn_\w*(?:sm90|resident)_kernel)I(.*?)EEv", line)
        if m and "entry function" in line:
            name = f"{m.group(1)}<{m.group(2)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers at entry, "
                       f"{spill} B spilled")
            name = None
    return out


def run_case(case, rng, dev) -> dict:
    b, h, d, nq, nk, hw, ss, scale = case
    c = h * d

    def randn(shape, s=1.0):
        return torch.from_numpy(
            rng.standard_normal(size=shape, dtype=np.float32) * s
        ).to(dev).bfloat16()

    # q, k, v as column blocks of one packed tensor: read by stride
    packed = torch.cat([randn((b, max(nq, nk), c)) for _ in range(3)], -1)
    q, k, v = (packed[:, :n, i * c:(i + 1) * c]
               for i, n in enumerate((nq, nk, nk)))
    dout = randn((b, nq, c))
    rh = rw = None
    if hw:
        rh, rw = randn((b, nq, h, hw[0]), 0.5), randn((b, nq, h, hw[1]), 0.5)
    gh, gw = hw if hw else (0, 0)
    scale = d ** -0.5 if scale is None else scale
    ref_out, ref_lse = A.attention_plain(q, k, v, scale, h, rh, rw,
                                         return_lse=True, scale_scores=ss)
    out, lse = A.attention_launch(q, k, v, scale, h, rh, rw, return_lse=True,
                                  scale_scores=ss, body="mma")
    ref = A.attention_backward_plain(q, k, v, out, lse, dout, scale, h, rh,
                                     rw, scale_scores=ss)
    delta = A.attention_delta(dout, out, h).contiguous()
    chosen = A.attention_body(q.dtype, d, nq, nk, hw is not None, hw)
    res = {}
    for body in dict.fromkeys(("mma", chosen)):
        got_out, got_lse = A.attention_launch(
            q, k, v, scale, h, rh, rw, return_lse=True, scale_scores=ss,
            body=body)
        without_lse = A.attention_launch(q, k, v, scale, h, rh, rw,
                                         scale_scores=ss, body=body)
        dpk = torch.zeros_like(packed)
        grads = tuple(dpk[:, :n, i * c:(i + 1) * c]
                      for i, n in enumerate((nq, nk, nk)))

        def backward(g=None, drel=True):
            return A.attention_backward_launch(
                q, k, v, out, lse, dout, scale, h, rh, rw, grads=g,
                want_drel=drel, scale_scores=ss, body=body)

        res[body] = dict(
            fwd_err=(got_out.float() - ref_out.float()).abs().max().item(),
            lse_err=(got_lse - ref_lse).abs().max().item(),
            same_without_lse=torch.equal(without_lse, got_out),
            fwd_ms=time_ms(lambda: A.attention_launch(
                q, k, v, scale, h, rh, rw, scale_scores=ss, body=body)),
            fwd_with_lse_ms=time_ms(lambda: A.attention_launch(
                q, k, v, scale, h, rh, rw, return_lse=True, scale_scores=ss,
                body=body)))
        runs = [backward(g) for g in (grads, None)]
        torch.cuda.synchronize()

        def one(kernel, drel=True):
            """One kernel alone: a tile body's with the delta pass's delta,
            the Hopper dk/dv kernel with what its dq kernel left."""
            tables = [torch.empty_like(t) if (hw and drel) else None
                      for t in (rh, rw)]
            if body == "sm90":
                scratch = A.sm90_scratch(q, h, scale, ss, hw is not None)

                def launch(kern):
                    A._sm90_backward_launch(
                        kern, q, k, v, dout, out, lse, scratch, rh, rw,
                        *grads, *tables, scale, h, d, gh, gw,
                        scale_scores=ss)
                if kernel == 1:
                    launch(0)
                return lambda: launch(kernel)
            return lambda: A._backward_kernel_launch(
                kernel, q, k, v, dout, lse, delta, rh, rw, *grads, *tables,
                scale, h, d, gh, gw, scale_scores=ss)

        res[body].update(
            bwd_rel_err=[(g.float() - r.float()).abs().max().item()
                         / max(r.float().abs().max().item(), 1e-6)
                         for g, r in zip(runs[0], ref) if r is not None],
            repeatable=all(torch.equal(g1, g2)
                           for g1, g2 in zip(*runs) if g1 is not None),
            bwd_ms=time_ms(lambda: backward(grads)),
            bwd_without_drel_ms=(time_ms(lambda: backward(grads, False))
                                 if hw else None))
        if body != "resident":          # the two-kernel bodies, piece by piece
            res[body].update(
                delta_ms=time_ms(lambda: A.attention_delta(
                    dout, out, h).contiguous()),
                dq_ms=time_ms(one(0)),
                dq_without_drel_ms=time_ms(one(0, False)) if hw else None,
                dkv_ms=time_ms(one(1)))
    return dict(batch=b, heads=h, d=d, nq=nq, nk=nk, grid=hw,
                scale_scores=ss, scale=scale, **res)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--main", action="store_true",
                    help="the main-path shapes only")
    ap.add_argument("--windowed", action="store_true",
                    help="the windowed cases only (the resident bodies)")
    ap.add_argument("--d80", action="store_true",
                    help="the head-dim-80 cases only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_kernels()
    print(json.dumps(dict(
        gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=round(time.perf_counter() - t0, 2),
        ptxas=hopper_ptxas((lib.parent / "build.log").read_text()))),
        flush=True)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    with torch.no_grad():
        cases = ([] if args.main else WINDOWED_RAGGED) + WINDOWED_MAIN
        if not args.windowed:
            cases += ([] if args.main else RAGGED) + MAIN
        if args.d80:
            cases = D80
        for case in cases:
            print(json.dumps(run_case(case, rng, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
