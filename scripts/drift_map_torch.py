"""Drift measured as mAP, not tensor distance, for the PyTorch port;
counterpart of scripts/drift_map.py over wildlifemapper_tpu_torch/eval/drift.py.

f32 full-canvas detections on the plain path (no kernels) act as pseudo
ground truth; the other configurations' detections are scored against them
with the port's COCOeval on synthetic-but-structured imagery (dark ellipse
'animals' on a smooth background: unlike white noise, detections are
stable under small perturbations). Rows: f32 plain again (self), f32
through the hand-written kernels (AP50 1.000 expected: the same function),
bf16 through the kernels on the full canvas, at the content crop, and with
crop_prologue (a different function: random init only, as a worst case).
Runs on the card unless --device says otherwise.

Usage:
  python scripts/drift_map_torch.py [--torch_checkpoint best_checkpoint]
      [--val_tiles [--coco_path DIR]] [--n_imgs 16] [--device cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wildlifemapper_tpu_torch.config import model_config  # noqa: E402
from wildlifemapper_tpu_torch.eval.drift import (drift_summary,  # noqa: E402
                                                 run_detections)
from wildlifemapper_tpu_torch.models import WildlifeMapper  # noqa: E402
from wildlifemapper_tpu_torch.train.checkpoints import \
    CheckpointManager  # noqa: E402

N_IMGS = 16
B = 4


def synth_tiles(rng, n, canvas=1024, content=768):
    """The JAX script's field (scripts/drift_map.py:26-38), the same numbers
    from the same rng; `canvas` / `content` other than 1024 / 768 only for
    a model of another input size."""
    tiles = np.zeros((n, canvas, canvas, 3), np.float32)
    yy, xx = np.mgrid[:content, :content]
    for i in range(n):
        bg = rng.normal(0.0, 0.05, size=(content, content, 3)).astype(
            np.float32)
        bg += (np.sin(xx / 97.0 + i) * 0.3)[..., None]
        for _ in range(int(rng.integers(3, 12))):
            cy, cx = rng.uniform(40, content - 40, 2)
            ry, rx = rng.uniform(6, 24, 2)
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            bg[m] = rng.uniform(-2.5, -1.5)
        tiles[i, :content, :content] = bg
    return tiles


def map_vs(gt_dets, pred_dets, n, gt_thresh=0.3):
    s = drift_summary(gt_dets, pred_dets, n, gt_thresh=gt_thresh)
    return s["AP"], s["AP50"]


def loader_tiles(n, coco_path=None):
    """Val-split tiles rendered by the training loader itself (the synthetic
    distribution a trained checkpoint saw), preprocessed as evaluation
    does (resize 768, normalize, 1024 canvas, no flip)."""
    from wildlifemapper_tpu_torch.config import DataConfig
    from wildlifemapper_tpu_torch.data.loader import build_dataset

    cfg = DataConfig(synthetic=True, flip_prob=0.0,
                     coco_path=coco_path or DataConfig.coco_path)
    ds = build_dataset("val", cfg)
    n = min(n, len(ds))
    tiles = np.stack([ds.get(i)["image"] for i in range(n)])
    return tiles.astype(np.float32), n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch_checkpoint", default=None,
                   help="a checkpoint file the port's trainer wrote (or a "
                        "bare state dict); default: seeded random init")
    p.add_argument("--val_tiles", action="store_true",
                   help="use loader-rendered val-split tiles instead of "
                        "the script's own synthetic field")
    p.add_argument("--n_imgs", type=int, default=N_IMGS)
    p.add_argument("--coco_path", default=None,
                   help="annotation dir for --val_tiles (use the set the "
                        "checkpoint was trained on)")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (raises without "
                        "CUDA), 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")

    cfg32 = model_config("vit_b", dtype="float32")
    canvas = cfg32.img_size
    content = canvas * 3 // 4
    if args.val_tiles:
        tiles, n = loader_tiles(args.n_imgs, args.coco_path)
    else:
        n = args.n_imgs
        tiles = synth_tiles(np.random.default_rng(0), n, canvas, content)

    cfg_k32 = dataclasses.replace(cfg32, use_flash_attention=True)
    cfg16 = dataclasses.replace(cfg_k32, dtype="bfloat16")
    cfg_crop = dataclasses.replace(cfg16, content_size=content)
    cfg_cp = dataclasses.replace(
        cfg_crop, crop_prologue=True,
        hfc=dataclasses.replace(cfg_crop.hfc,
                                compat_scrambled_reshape=False))

    m32 = WildlifeMapper(cfg32, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).eval()
    if args.torch_checkpoint:
        CheckpointManager.load_params(args.torch_checkpoint, m32)
        print(f"loaded trained params from {args.torch_checkpoint}",
              flush=True)
    weights = m32.state_dict()

    def run(cfg):
        if cfg is cfg32:
            model = m32
        else:
            model = WildlifeMapper(cfg, device=dev).eval()
            model.load_state_dict(weights)
        return run_detections(model, tiles, batch=B, img_size=canvas)

    configs = [("f32-self ", cfg32), ("f32+kernels", cfg_k32),
               ("bf16+flash", cfg16), ("bf16+crop ", cfg_crop)]
    if not args.torch_checkpoint:
        # crop_prologue is a different function; only meaningful against
        # random init as a worst-case illustration (a trained checkpoint
        # is never served in a mode it was not trained in)
        configs.append(("bf16+crop_prologue", cfg_cp))

    gt = run(cfg32)
    n_gt = int((gt["scores"] > 0.3).sum())
    print(f"pseudo-GT detections: {n_gt}", flush=True)
    for tag, cfg in configs:
        dets = run(cfg)
        ap, ap50 = map_vs(gt, dets, n)
        print(f"{tag}: AP={ap:.4f} AP50={ap50:.4f}", flush=True)
        # the serving threshold's pseudo GT (0.5, visualize_prediction.py:150)
        ap_s, ap50_s = map_vs(gt, dets, n, gt_thresh=0.5)
        print(f"{tag.strip()}@serve0.5: AP={ap_s:.4f} AP50={ap50_s:.4f}",
              flush=True)


if __name__ == "__main__":
    main()
