"""Where the serving time of the PyTorch port goes, on a CUDA GPU.

    python scripts/profile_port.py [--config full_canvas|compat_crop|from_scratch]
                                   [--plain] [--batch 4] [--iters 3]

Runs forward + postprocess + NMS at ViT-B width in bf16 (random weights from
a seed) under torch.profiler and prints JSON lines: the device time by
kernel name (top 15), the summed device time, the wall time and the device
idle share over the profiled window, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wildlifemapper_tpu_torch.config import model_config  # noqa: E402
from wildlifemapper_tpu_torch.eval.postprocess import (  # noqa: E402
    batched_nms, postprocess)
from wildlifemapper_tpu_torch.models import WildlifeMapper  # noqa: E402


def config(name: str, plain: bool):
    cfg = model_config("vit_b", dtype="bfloat16",
                       use_flash_attention=not plain)
    if name == "compat_crop":
        cfg = dataclasses.replace(cfg, content_size=768)
    elif name == "from_scratch":
        cfg = dataclasses.replace(
            cfg, content_size=768, crop_prologue=True,
            vit=dataclasses.replace(cfg.vit, window_size=12),
            hfc=dataclasses.replace(cfg.hfc, compat_scrambled_reshape=False))
    return cfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="full_canvas",
                    choices=["full_canvas", "compat_crop", "from_scratch"])
    ap.add_argument("--plain", action="store_true",
                    help="plain PyTorch path (use_flash_attention=False)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    dev = torch.device("cuda")
    model = WildlifeMapper(config(args.config, args.plain),
                           generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.zeros(args.batch, 1024, 1024, 3, device=dev)
    x[:, :768, :768] = torch.randn(args.batch, 768, 768, 3, device=dev,
                                   generator=g)
    sizes = torch.full((args.batch, 2), 1024, dtype=torch.int32, device=dev)

    def step():
        out = model(x)
        dets = postprocess(out, sizes, 0.05)
        return batched_nms(dets["boxes"], dets["scores"], dets["labels"],
                           dets["keep"], 0.4)

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000 / args.iters

    # device-side events only: CPU ops also carry their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1000
    device_ms /= args.iters
    head = {"config": args.config,
            "path": "plain" if args.plain else "kernels",
            "batch": args.batch, "gpu": gpu, "wall_ms_per_batch": wall_ms,
            "device_ms_per_batch": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms / wall_ms)}
    print(json.dumps(head), flush=True)
    for e in events[:15]:
        ms = e.self_device_time_total / 1000 / args.iters
        print(json.dumps({"kernel": e.key[:90], "ms_per_batch": ms,
                          "share": ms / device_ms,
                          "calls_per_batch": e.count / args.iters}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
