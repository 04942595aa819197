"""One-shot evidence chain for the north-star conjunction (BASELINE.json),
for the PyTorch port; counterpart of scripts/conjunction.py: a single named
configuration that (a) serves full-canvas-trained weights at >= 0.99 mAP
parity with the parity path and (b) sustains >= 125 tiles/s.

The named configuration is the port's **checkpoint-compat crop tier**
(`content_size=768`, bf16 through the hand-written CUDA kernels, packed
layout): the same weights and the same function per token as the full
canvas, only the zero-pad ring dropped.

Given a checkpoint the port's trainer wrote (`cli/train.py --synthetic_data
--use_amp --train_encoder ...`: best_checkpoint or checkpoint_epoch_N under
--work_dir), this script measures, on the card unless --device says
otherwise:

  1. drift-as-mAP: f32 full-canvas detections as pseudo ground truth, the
     crop tier's detections scored against them with the port's COCOeval
     over loader-rendered val tiles (scripts/drift_map_torch.py, a
     subprocess);
  2. AP against the annotations for both the parity tier and the crop tier
     (cli/evaluate.py);
  3. the crop tier's throughput at batch 16, in tiles/s (CUDA events).

and prints one JSON verdict line with the JAX script's keys and rules.
`meets_5x` applies the JAX script's 125 tiles/s threshold to this device's
own reading.

Usage:
  python scripts/conjunction_torch.py --torch_checkpoint run/best_checkpoint
      [--n_imgs 64] [--coco_path DIR] [--skip_drift] [--skip_throughput]
      [--device cpu]
"""
import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wildlifemapper_tpu_torch.config import model_config  # noqa: E402

CONFIG = ("checkpoint-compat crop (content_size=768, bf16 through the CUDA "
          "kernels, packed)")
# BASELINE.json's throughput target, tiles/s at batch 16
TARGET_TILES_PER_S = 125.0
DRIFT_TIMEOUT_S = 7200


def throughput(batch=16, iters=10, device=None, cfg=None):
    """Tiles/s of the crop tier (`cfg`, by default ViT-B at content_size 768
    in bf16 through the kernels) on seeded weights: each iteration the
    forward then postprocess at 0.05, on content_size-px normal content in a
    zero canvas; warmed up, then `iters` iterations between two CUDA events
    (the host clock on the CPU)."""
    from wildlifemapper_tpu_torch.eval.postprocess import postprocess
    from wildlifemapper_tpu_torch.models import WildlifeMapper

    cfg = cfg or model_config("vit_b", dtype="bfloat16",
                              use_flash_attention=True, content_size=768)
    dev = torch.device(device or "cuda")
    model = WildlifeMapper(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).eval()
    canvas, content = cfg.img_size, cfg.content_size
    rng = np.random.default_rng(0)
    x = np.zeros((batch, canvas, canvas, 3), np.float32)
    x[:, :content, :content, :] = rng.normal(size=(batch, content, content,
                                                   3))
    x = torch.from_numpy(x).to(dev)
    orig = torch.full((batch, 2), canvas, dtype=torch.int32, device=dev)

    def pipeline():
        return postprocess(model(x), orig, 0.05)

    with torch.inference_mode():
        pipeline()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                pipeline()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                pipeline()
            seconds = time.perf_counter() - t0
    return batch / (seconds / iters)


def eval_ap(ckpt, content_size=None, batch_size=8, coco_path=None,
            device=None, extra=()):
    """AP vs real annotations through the port's evaluate CLI (synthetic val
    tiles); `extra` are more of its flags. aux_loss needs no flag here: deep
    supervision reuses the final heads, so aux-trained checkpoints restore
    into the plain eval model as-is."""
    # --fix_hw_swap: the AP-vs-GT legs score against the annotation file's
    # true [h, w] frame, so the reference's PostProcess h/w-swap quirk
    # (build_sam.py:252, a no-op on square tiles) must be disabled here:
    # the Mara frames are 5472x3648 and the swap misplaces every box. Drift
    # legs compare detections to detections, so they are frame-consistent
    # either way.
    args = ["--synthetic_data", "--use_amp", "--fix_hw_swap",
            "--torch_checkpoint", ckpt, "--batch_size", str(batch_size)]
    if content_size:
        args += ["--content_size", str(content_size)]
    if coco_path:
        args += ["--coco_path", coco_path]
    if device:
        args += ["--device", str(device)]
    args += list(extra)
    from wildlifemapper_tpu_torch.cli import evaluate as eval_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_cli.main(args)
    out = {}
    for line in buf.getvalue().splitlines():
        for key in ("AP", "AP50"):
            if line.startswith(f"coco/{key}:"):
                out[key] = float(line.split(":")[1])
    if "AP" not in out:
        raise RuntimeError("no AP in evaluate output:\n" + buf.getvalue())
    return out


def drift_leg(cmd, timeout=DRIFT_TIMEOUT_S):
    """Run the drift script; a crashed or timed-out run comes back as a
    CompletedProcess with a nonzero returncode, its output kept."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired as e:
        # A timed-out drift leg must not take the whole verdict down with
        # it: the leg is marked failed and the AP and throughput legs still
        # produce a (partial) verdict line. TimeoutExpired's captured output
        # may be None or bytes regardless of text=True.
        def _s(v):
            return v.decode(errors="replace") if isinstance(v, bytes) \
                else (v or "")
        return subprocess.CompletedProcess(
            cmd, returncode=-1, stdout=_s(e.stdout),
            stderr=_s(e.stderr) + f"\nDRIFT LEG TIMED OUT ({timeout}s)")


def parse_drift(stdout):
    """{tag: AP} from drift_map_torch.py's `<tag>: AP=... AP50=...` lines."""
    drift_ap = {}
    for line in stdout.splitlines():
        if ": AP=" in line:
            tag, rest = line.split(": AP=")
            drift_ap[tag.strip()] = float(rest.split()[0])
    return drift_ap


def assemble_verdict(drift_ap, ap_full, ap_crop, tps, skip_drift,
                     skip_throughput, checkpoint, coco_path):
    """The verdict line's object (the JAX script's keys and rules)."""
    # Skipped or failed legs are null in the verdict: a complete-looking
    # line must mean every leg actually ran. `partial` names the missing
    # legs explicitly.
    partial = []
    if skip_drift:
        partial.append("drift")
    elif not drift_ap:
        partial.append("drift(failed)")
    if skip_throughput:
        partial.append("throughput")
    crop_drift = drift_ap.get("bf16+crop")
    crop_drift_serve = drift_ap.get("bf16+crop@serve0.5")
    # mAP parity of record: both tiers against the SAME real GT, the metric
    # the reference publishes (inference.py:80-88). Drift-AP (detections
    # against detections) is the stricter secondary diagnostic. AP50 ratios
    # ride along: at moderate absolute AP the @[.5:.95] ratio is dominated
    # by localization noise while AP50 is stable.
    map_ratio = (ap_crop["AP"] / ap_full["AP"]
                 if ap_full["AP"] > 0 else None)
    map50_ratio = (ap_crop["AP50"] / ap_full["AP50"]
                   if ap_full.get("AP50", 0) > 0 else None)
    meets_parity = None
    if map_ratio is not None or crop_drift is not None:
        meets_parity = bool((map_ratio or 0.0) >= 0.99
                            or (crop_drift or 0.0) >= 0.99)
    return {
        "config": CONFIG,
        "drift_ap_vs_f32_full_canvas": crop_drift,
        "drift_ap_serving_threshold": crop_drift_serve,
        "parity_tier_drift_ap": drift_ap.get("bf16+flash"),
        "ap_vs_gt_full_canvas": ap_full["AP"],
        "ap_vs_gt_crop": ap_crop["AP"],
        "ap50_vs_gt_full_canvas": ap_full.get("AP50"),
        "ap50_vs_gt_crop": ap_crop.get("AP50"),
        "map_parity_ratio": None if map_ratio is None else round(map_ratio, 4),
        "map50_parity_ratio": (None if map50_ratio is None
                               else round(map50_ratio, 4)),
        "tiles_per_sec_b16": None if tps is None else round(tps, 1),
        "meets_parity": meets_parity,
        "meets_5x": None if tps is None else bool(tps >= TARGET_TILES_PER_S),
        "partial": partial,
        # which weights produced this line: the verdict must be readable on
        # its own
        "checkpoint": checkpoint,
        "coco_path": coco_path,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--torch_checkpoint", required=True,
                    help="a checkpoint file the port's trainer wrote; takes "
                         "the place of the JAX script's --orbax_checkpoint")
    ap.add_argument("--n_imgs", type=int, default=64)
    ap.add_argument("--coco_path", default=None,
                    help="annotation dir the checkpoint was trained on "
                         "(e.g. the scaled-box benchmark set)")
    ap.add_argument("--skip_drift", action="store_true",
                    help="skip the drift-as-mAP leg; the stricter "
                         "diagnostic can run separately "
                         "(scripts/drift_map_torch.py)")
    ap.add_argument("--skip_throughput", action="store_true",
                    help="skip the crop-tier throughput leg")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "CUDA), 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")

    drift_ap = {}
    if not args.skip_drift:
        # 1. drift-as-mAP with trained weights (a subprocess: the drift
        # script builds five models; isolating it keeps this process lean)
        drift_cmd = [
            sys.executable,
            str(Path(__file__).resolve().parent / "drift_map_torch.py"),
            "--torch_checkpoint", args.torch_checkpoint, "--val_tiles",
            "--n_imgs", str(args.n_imgs)]
        if args.coco_path:
            drift_cmd += ["--coco_path", args.coco_path]
        if args.device:
            drift_cmd += ["--device", args.device]
        drift = drift_leg(drift_cmd)
        if drift.returncode != 0:
            # a crashed drift leg must be visible, never a silent null
            print(f"DRIFT LEG FAILED (rc={drift.returncode}):",
                  file=sys.stderr)
            print(drift.stderr, file=sys.stderr)
        drift_ap = parse_drift(drift.stdout)
        print(drift.stdout)

    # 2. AP vs annotations, both tiers
    ap_full = eval_ap(args.torch_checkpoint, coco_path=args.coco_path,
                      device=args.device)
    ap_crop = eval_ap(args.torch_checkpoint, content_size=768,
                      coco_path=args.coco_path, device=args.device)

    # 3. crop-tier throughput
    tps = None if args.skip_throughput else throughput(device=dev)

    print("device: " + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"), flush=True)
    verdict = assemble_verdict(drift_ap, ap_full, ap_crop, tps,
                               args.skip_drift, args.skip_throughput,
                               args.torch_checkpoint, args.coco_path)
    # allow_nan=False: any NaN sneaking back in is a bug, fail loudly
    print(json.dumps(verdict, allow_nan=False))
    return verdict


if __name__ == "__main__":
    main()
