"""Where the serving or training time of the PyTorch port goes, on a CUDA GPU.

    python scripts/profile_port.py [--config full_canvas|compat_crop|from_scratch]
                                   [--plain | --attn-impl grouped]
                                   [--variant vit_b|vit_l|vit_h]
                                   [--batch 4] [--iters 3] [--root CHECKOUT]
    python scripts/profile_port.py --train fine_tune|from_scratch
                                   [--plain | --attn-impl grouped]
    python scripts/profile_port.py ... --no-trace [--iters 20]
    python scripts/profile_port.py --k3

Runs forward + postprocess + NMS, or with --train whole train steps on a
synthetic batch (train/synthetic.py), at ViT-B width in bf16 (random weights
from a seed; serving also at ViT-L's or ViT-H's with --variant) under
torch.profiler and prints JSON lines: the device time by
kernel name (top 15), the summed device time, the wall time and the device
idle share over the profiled window, with the card's name and power limit.
Each kernel of the port is named beside its device name ("port_kernel":
K3's GEMM body is "K3 forward" for its two passes and "K3 dh"; the attention
kernels by body and direction), and one more line sums the device time of
each. --attn-impl picks the kernels' layout: packed (K1, K2, K3, K4; the
default) or grouped (K6, K5, K4 and the plain MLP). --no-trace times the
same steps without the profiler, which slows the host: one JSON line with
the wall-clock ms per batch or step over --iters. --root imports the
package of another checkout (this script's own by default), so that one
call can profile an older tree beside this one.

--k3 times K3 alone in bf16 at ViT-B's width (D 768, F 3072) through its
public wrappers, `fused_mlp` (the forward) and `fused_mlp_dh` (the
backward's dh kernel), at R = 16384 and 9216 (the main paths) and 256 (where
the host sets the pace): device ms by CUDA events over 20 calls, and host us
of one call (the wall clock around 50 calls that only queue work for an idle
card). It uses nothing else of the package, so the same script can be run
in a checkout of an earlier tree to compare launchers.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

_root = argparse.ArgumentParser(add_help=False)
_root.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                   help="checkout whose package is profiled")
sys.path.insert(0, str(Path(_root.parse_known_args()[0].root).resolve()))

from wildlifemapper_tpu_torch.config import model_config  # noqa: E402
from wildlifemapper_tpu_torch.eval.postprocess import (  # noqa: E402
    batched_nms, postprocess)
from wildlifemapper_tpu_torch.models import WildlifeMapper  # noqa: E402
from wildlifemapper_tpu_torch.train.step import StepBuilder  # noqa: E402
from wildlifemapper_tpu_torch.train.synthetic import (  # noqa: E402
    TRAINING_CONFIGS, synthetic_batch, training_config)


# (pattern of the device kernel's name, the port's kernel)
PORT_KERNELS = [
    (r"fused_mlp_gemm_sm90_kernel<[01]>", "K3 forward"),
    (r"fused_mlp_gemm_sm90_kernel<2>", "K3 dh"),
    (r"fused_mlp_kernel<", "K3 forward (f32)"),
    (r"mlp_dh_kernel<", "K3 dh (f32)"),
    (r"attn_fwd_resident", "attention forward, resident (K1 / K6)"),
    (r"attn_bwd_resident", "attention backward, resident (K1 / K6)"),
    (r"attn_fwd_sm90", "attention forward, sm90 (K2 / K4 / K5)"),
    (r"attn_bwd_dq_sm90", "attention backward dq, sm90 (K2 / K4 / K5)"),
    (r"attn_bwd_dkv_sm90", "attention backward dk/dv, sm90 (K2 / K4 / K5)"),
    (r"attn_(tc|fwd)_kernel", "attention forward, mma.sync / f32 tiles"),
    (r"attn_bwd_dq_(tc_)?kernel", "attention backward dq, tiles"),
    (r"attn_bwd_dkv_(tc_)?kernel", "attention backward dk/dv, tiles"),
]


def port_kernel(name: str):
    """Which of the port's kernels a device kernel is, or None."""
    for pattern, label in PORT_KERNELS:
        if re.search(pattern, name):
            return label
    return None


def k3_times(gpu: str) -> None:
    """--k3: one JSON line a row count, forward and dh."""
    from wildlifemapper_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_dh

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device=dev, generator=g)
                * scale).to(dtype)

    def device_ms(fn, iters=20):
        for _ in range(3):
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

    def host_us(fn, calls=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    d, f = 768, 3072
    w1, w2 = randn(f, d, scale=d ** -0.5), randn(d, f, scale=f ** -0.5)
    b1 = randn(f, scale=0.1, dtype=torch.float32)
    b2 = randn(d, scale=0.1, dtype=torch.float32)
    with torch.no_grad():
        for rows in (16384, 9216, 256):
            x, da = randn(rows, d), randn(rows, f)
            fwd = lambda: fused_mlp(x, w1, b1, w2, b2)  # noqa: E731
            dh = lambda: fused_mlp_dh(x, w1, b1, da)  # noqa: E731
            print(json.dumps({
                "k3": f"R={rows} D={d} F={f}", "dtype": "bfloat16",
                "gpu": gpu, "forward_ms": device_ms(fwd),
                "forward_host_us": host_us(fwd), "dh_ms": device_ms(dh),
                "dh_host_us": host_us(dh),
                "forward_bound_ms": 4 * rows * d * f / 989e12 * 1e3,
                "dh_bytes_bound_ms": 2 * rows * (d + 3 * f) / 3.35e12 * 1e3}),
                flush=True)


def config(name: str, plain: bool, attn_impl: str = "packed",
           variant: str = "vit_b"):
    cfg = model_config(variant, dtype="bfloat16",
                       use_flash_attention=not plain, attn_impl=attn_impl)
    if name == "compat_crop":
        cfg = dataclasses.replace(cfg, content_size=768)
    elif name == "from_scratch":
        cfg = dataclasses.replace(
            cfg, content_size=768, crop_prologue=True,
            vit=dataclasses.replace(cfg.vit, window_size=12),
            hfc=dataclasses.replace(cfg.hfc, compat_scrambled_reshape=False))
    return cfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 parents=[_root])
    ap.add_argument("--config", default="full_canvas",
                    choices=["full_canvas", "compat_crop", "from_scratch"])
    ap.add_argument("--plain", action="store_true",
                    help="plain PyTorch path (use_flash_attention=False)")
    ap.add_argument("--attn-impl", default="packed",
                    choices=["packed", "grouped"],
                    help="layout of the attention kernels (ignored with "
                         "--plain)")
    ap.add_argument("--train", choices=TRAINING_CONFIGS, default=None,
                    help="profile train steps in this training configuration "
                         "instead of serving")
    ap.add_argument("--no-trace", action="store_true",
                    help="time the steps by the wall clock, without "
                         "torch.profiler")
    ap.add_argument("--k3", action="store_true",
                    help="time K3's forward and dh wrappers alone")
    ap.add_argument("--variant", default="vit_b",
                    choices=["vit_b", "vit_l", "vit_h"],
                    help="the encoder served (training runs ViT-B)")
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    if args.k3:
        k3_times(gpu)
        return 0

    def profiled(step):
        step()
        torch.cuda.synchronize()
        with (contextlib.nullcontext() if args.no_trace else
              torch.profiler.profile(activities=acts)) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000 / args.iters
        return prof, wall_ms

    if args.train and args.variant != "vit_b":
        ap.error("--train runs ViT-B only")
    if args.train:
        cfg = training_config(args.train, use_kernels=not args.plain,
                              batch_size=args.batch)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, attn_impl=args.attn_impl))
        builder = StepBuilder(cfg, generator=torch.Generator().manual_seed(0))
        state = builder.init_state(steps_per_epoch=100)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthetic_batch(args.batch, seed=1).items()}
        g = torch.Generator(device=dev).manual_seed(1)
        prof, wall_ms = profiled(
            lambda: builder.train_step(state, batch, g))
    else:
        model = WildlifeMapper(config(args.config, args.plain,
                                      args.attn_impl, args.variant),
                               generator=torch.Generator().manual_seed(0))
        model.eval()
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.zeros(args.batch, 1024, 1024, 3, device=dev)
        x[:, :768, :768] = torch.randn(args.batch, 768, 768, 3, device=dev,
                                       generator=g)
        sizes = torch.full((args.batch, 2), 1024, dtype=torch.int32,
                           device=dev)

        def step():
            out = model(x)
            dets = postprocess(out, sizes, 0.05)
            return batched_nms(dets["boxes"], dets["scores"], dets["labels"],
                               dets["keep"], 0.4)

        with torch.inference_mode():
            prof, wall_ms = profiled(step)

    head = {"config": args.train or args.config,
            "variant": args.variant, "root": args.root,
            "mode": "train" if args.train else "serve",
            "path": "plain" if args.plain else f"kernels, {args.attn_impl}",
            "batch": args.batch, "gpu": gpu, "wall_ms_per_batch": wall_ms}
    if args.no_trace:
        print(json.dumps(dict(head, iters=args.iters)), flush=True)
        return 0
    # device-side events only: CPU ops also carry their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1000
    device_ms /= args.iters
    print(json.dumps(dict(head, device_ms_per_batch=device_ms,
                          device_idle_share=max(0.0, 1 - device_ms / wall_ms))),
          flush=True)
    for e in events[:15]:
        ms = e.self_device_time_total / 1000 / args.iters
        print(json.dumps({"kernel": e.key[:90],
                          "port_kernel": port_kernel(e.key),
                          "ms_per_batch": ms, "share": ms / device_ms,
                          "calls_per_batch": e.count / args.iters}),
              flush=True)
    by_port = {}
    for e in events:
        label = port_kernel(e.key)
        if label is not None:
            ms, calls = by_port.get(label, (0.0, 0.0))
            by_port[label] = (ms + e.self_device_time_total / 1000
                              / args.iters, calls + e.count / args.iters)
    print(json.dumps({"port_kernels_ms_per_batch": {
        k: v[0] for k, v in by_port.items()}, "port_kernels_calls_per_batch": {
        k: v[1] for k, v in by_port.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
