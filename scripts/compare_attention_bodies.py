"""The two bf16 bodies of the port's attention kernels side by side on one
NVIDIA GPU (written for the H100): "mma" (mma.sync tiles, csrc/attention_fwd.cuh
and attention_bwd.cuh) and "sm90" (wgmma and a TMA-fed ring,
csrc/attention_fwd_sm90.cuh and attention_bwd_sm90.cuh).

    python3 scripts/compare_attention_bodies.py            # every case
    python3 scripts/compare_attention_bodies.py --main     # main-path shapes only

For each case (batch, heads, d, queries, keys, rel grid, scale placement) it
builds the kernels (registers and spills of the Hopper instantiations are
printed from nvcc's -Xptxas -v), runs forward and both backward kernels of
each body at the launcher (ops/_attention.py, `body=`), and prints one JSON
line: the largest forward error and the backward errors relative to each
gradient's largest element against the plain version, whether a second
backward is bit-identical, and CUDA-event times in ms (forward, dq with and
without the rel-table gradients, dk/dv), each body warmed up and timed over
five launches. The card's name and power limit come first. Fails without
CUDA.
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

# batch, heads, d, queries, keys, rel grid, scale on the f32 scores
RAGGED = [
    (2, 2, 64, 128, 512, None, False),
    (2, 2, 128, 128, 512, None, True),
    (2, 2, 64, 128, 512, (8, 64), False),
    (2, 3, 64, 1000, 1000, (25, 40), False),
    (2, 3, 64, 1000, 1000, (20, 50), True),
    (1, 2, 128, 300, 1030, None, False),
    (2, 1, 128, 513, 513, (27, 19), True),
]
MAIN = [
    (4, 12, 64, 4096, 4096, (64, 64), False),    # K2, full canvas
    (48, 1, 64, 4096, 4096, (64, 64), True),     # K5
    (4, 12, 64, 2304, 2304, (48, 48), False),    # K2, 48-grid
    (48, 1, 64, 2304, 2304, (48, 48), True),     # K5
    (4, 8, 128, 4096, 4096, None, False),        # K4
    (4, 8, 128, 2304, 2304, None, False),
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
        m = re.search(r"(attn_\w*sm90_kernel)I(.*?)EEv", line)
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
    b, h, d, nq, nk, hw, ss = case
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
    scale = d ** -0.5
    ref_out, _ = A.attention_plain(q, k, v, scale, h, rh, rw,
                                   return_lse=True, scale_scores=ss)
    out, lse = A.attention_launch(q, k, v, scale, h, rh, rw, return_lse=True,
                                  scale_scores=ss, body="mma")
    ref = A.attention_backward_plain(q, k, v, out, lse, dout, scale, h, rh,
                                     rw, scale_scores=ss)
    delta = A.attention_delta(dout, out, h).contiguous()
    res = {}
    for body in A.BODIES:
        got_out = A.attention_launch(q, k, v, scale, h, rh, rw,
                                     scale_scores=ss, body=body)
        dpk = torch.zeros_like(packed)
        grads = tuple(dpk[:, :n, i * c:(i + 1) * c]
                      for i, n in enumerate((nq, nk, nk)))
        runs = [A.attention_backward_launch(
            q, k, v, out, lse, dout, scale, h, rh, rw, grads=g,
            scale_scores=ss, body=body) for g in (grads, None)]
        torch.cuda.synchronize()

        def one(kernel, drel=True):
            tables = [torch.empty_like(t) if (hw and drel) else None
                      for t in (rh, rw)]
            return lambda: A._backward_kernel_launch(
                kernel, q, k, v, dout, lse, delta, rh, rw, *grads, *tables,
                scale, h, d, gh, gw, scale_scores=ss, body=body)

        res[body] = dict(
            fwd_err=(got_out.float() - ref_out.float()).abs().max().item(),
            bwd_rel_err=[(g.float() - r.float()).abs().max().item()
                         / max(r.float().abs().max().item(), 1e-6)
                         for g, r in zip(runs[0], ref) if r is not None],
            repeatable=all(torch.equal(g1, g2)
                           for g1, g2 in zip(*runs) if g1 is not None),
            fwd_ms=time_ms(lambda: A.attention_launch(
                q, k, v, scale, h, rh, rw, scale_scores=ss, body=body)),
            dq_ms=time_ms(one(0)),
            dq_without_drel_ms=time_ms(one(0, False)) if hw else None,
            dkv_ms=time_ms(one(1)))
    return dict(batch=b, heads=h, d=d, nq=nq, nk=nk, grid=hw,
                scale_scores=ss, **res)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--main", action="store_true",
                    help="the main-path shapes only")
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
        for case in (MAIN if args.main else RAGGED + MAIN):
            print(json.dumps(run_case(case, rng, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
