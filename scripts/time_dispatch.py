"""The host's cost of entering the kernels, and the serving wall it moves,
on one NVIDIA GPU (written for the H100), for comparing two checkouts in
turns.

    python3 scripts/time_dispatch.py [--root CHECKOUT] [--label L]
        [--turns 5]

`--root` is the checkout whose `wildlifemapper_tpu_torch` is imported (this
script's own by default), so that one call can time an older tree with the
same script: run it as parent / change / change / parent. Only what every
tree of the port has is used: the K1 and K3 wrappers
(`windowed_attention_packed`, `fused_mlp`) at their full-canvas serving
shapes in bf16 (BW 100, N 196, 12 heads of 64; R 16384, 768 -> 3072), each
call's host microseconds (the wall clock around 200 calls that only queue
work for an idle card; the least of --turns turns, which is the call's own
cost on a shared host, and the median), and the full-canvas
packed serving of ViT-B in bf16 at batch 4 (forward + postprocess + NMS,
seeded weights, 768-px content in the 1024 canvas, as `chip_smoke.py`
phase 4 serves it): wall ms a batch over 10 batches, --turns times, and by
CUDA events. One JSON line, with the card's name and power limit. Fails
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_root = argparse.ArgumentParser(add_help=False)
_root.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                   help="checkout whose package is timed")
sys.path.insert(0, str(Path(_root.parse_known_args()[0].root).resolve()))

from wildlifemapper_tpu_torch.config import model_config  # noqa: E402
from wildlifemapper_tpu_torch.eval.postprocess import (  # noqa: E402
    batched_nms, postprocess)
from wildlifemapper_tpu_torch.models import WildlifeMapper  # noqa: E402
from wildlifemapper_tpu_torch.ops.fused_mlp import fused_mlp  # noqa: E402
from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (  # noqa: E402
    windowed_attention_packed)

BATCH = 4


def host_us(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    p = argparse.ArgumentParser(parents=[_root], description=__doc__)
    p.add_argument("--label", default="")
    p.add_argument("--turns", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_dispatch: needs a CUDA GPU", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rb(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    qkv, rh, rw = rb(100, 196, 3 * 768), rb(100, 196, 12, 14, scale=0.5), \
        rb(100, 196, 12, 14, scale=0.5)
    x, w1, w2 = rb(4 * 4096, 768), rb(3072, 768, scale=768 ** -0.5), \
        rb(768, 3072, scale=3072 ** -0.5)
    b1 = torch.randn(3072, generator=g, device=dev) * 0.1
    b2 = torch.randn(768, generator=g, device=dev) * 0.1
    calls = {
        "K1": lambda: windowed_attention_packed(qkv, rh, rw, 0.125, 12,
                                                (14, 14)),
        "K3": lambda: fused_mlp(x, w1, b1, w2, b2),
    }
    host = {k: [] for k in calls}
    with torch.inference_mode():
        for _ in range(args.turns):
            for k, fn in calls.items():
                host[k].append(host_us(fn))
    del qkv, rh, rw, x, w1, w2, b1, b2

    cfg = model_config("vit_b", dtype="bfloat16", use_flash_attention=True)
    model = WildlifeMapper(cfg, generator=torch.Generator(
        device=dev).manual_seed(0)).eval()
    xb = np.zeros((BATCH, 1024, 1024, 3), np.float32)
    xb[:, :768, :768, :] = np.random.default_rng(100).standard_normal(
        size=(BATCH, 768, 768, 3), dtype=np.float32)
    xb = torch.from_numpy(xb).to(dev)
    sizes = torch.full((BATCH, 2), 1024, dtype=torch.int32, device=dev)

    def serve():
        out = model(xb)
        dets = postprocess(out, sizes, confidence_threshold=0.05)
        dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                   dets["labels"], dets["keep"], 0.4,
                                   class_aware=False)
        return dets

    walls = []
    with torch.inference_mode():
        for _ in range(2):
            serve()
        torch.cuda.synchronize()
        for _ in range(args.turns):
            t0 = time.perf_counter()
            for _ in range(10):
                serve()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / 10 * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            serve()
        end.record()
        torch.cuda.synchronize()
    print(json.dumps({
        "label": args.label, "root": args.root, "gpu": gpu,
        "host_us": {k: min(v) for k, v in host.items()},
        "host_us_median": {k: float(np.median(v)) for k, v in host.items()},
        "host_us_turns": host,
        "serving_full_canvas_packed_wall_ms": float(np.median(walls)),
        "serving_wall_ms_turns": walls,
        "serving_events_ms": start.elapsed_time(end) / 10}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
