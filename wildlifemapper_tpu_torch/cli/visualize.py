"""Prediction visualization CLI of the PyTorch port; counterpart of
wildlifemapper_tpu/cli/visualize.py, with its flags (`--torch_checkpoint`
in place of `--orbax_checkpoint`).

Behavioral parity target: visualize_prediction.py — run the val loader
through a trained model, keep detections with score > 0.5, apply NMS at IoU
0.4 (:150-157), draw per-species colored boxes (:82-133) and write
prediction_plots/<image_id>.jpg. The forward, postprocess and NMS run on the
card; drawing uses PIL, which is imported only to draw, so this CLI runs
where PIL is installed (the card's own machine has none: run it on a
workstation with a GPU, or with --device cpu).
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np

from ..train.logging import draw_detections
from .train import add_config_args, add_device_arg, config_from_args


def render_overlay(image, size, boxes, labels, scores, gt_boxes=None,
                   gt_valid=None):
    """The content region (h, w) = `size` of one pipeline image (normalised
    f32, denormalised here, or uint8), with the ground truth's normalised
    cxcywh boxes in thin white when given, under the detections drawn in
    their species' colours. PIL imported here."""
    from PIL import Image, ImageDraw

    from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD

    h, w = int(size[0]), int(size[1])
    arr = np.asarray(image)[:h, :w]
    if arr.dtype != np.uint8:
        arr = ((arr * IMAGENET_STD + IMAGENET_MEAN) * 255).clip(0, 255)
    img = Image.fromarray(arr.astype(np.uint8))
    if gt_boxes is not None:
        d = ImageDraw.Draw(img)
        for (cx, cy, bw, bh), ok in zip(np.asarray(gt_boxes),
                                        np.asarray(gt_valid)):
            if not ok:
                continue
            d.rectangle([(cx - bw / 2) * w, (cy - bh / 2) * h,
                         (cx + bw / 2) * w, (cy + bh / 2) * h],
                        outline=(255, 255, 255), width=1)
    return draw_detections(img, boxes, labels, scores)


def main(argv=None):
    p = add_config_args(argparse.ArgumentParser(__doc__))
    p.add_argument("--split", default="val")
    p.add_argument("--output_dir", default="prediction_plots")
    p.add_argument("--score_threshold", type=float, default=0.5)
    p.add_argument("--nms_iou", type=float, default=0.4)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--torch_checkpoint", default=None,
                   help="a checkpoint file written by the port's trainer "
                        "(the reference .pth --checkpoint also works)")
    p.add_argument("--use_ema", action="store_true",
                   help="visualize the EMA weights of --torch_checkpoint")
    p.add_argument("--config_json", default=None,
                   help="config.json written by the trainer beside its "
                        "checkpoints; overrides the flag-derived model "
                        "config (see cli/evaluate)")
    p.add_argument("--draw_gt", action="store_true",
                   help="also draw the ground-truth boxes (thin white) "
                        "under the detections — qualitative eval at a "
                        "glance")
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    if args.config_json:
        from ..config import config_from_json
        with open(args.config_json) as f:
            saved = config_from_json(f.read())
        cfg = dataclasses.replace(cfg, model=saved.model,
                                  criterion=saved.criterion)

    import torch

    from ..data.loader import DataLoader, build_dataset
    from ..eval.postprocess import batched_nms, postprocess
    from ..models import WildlifeMapper

    model = WildlifeMapper(cfg.model, generator=torch.Generator().manual_seed(0),
                           device=args.device).eval()
    if args.checkpoint:
        from ..compat.torch_convert import convert_checkpoint
        convert_checkpoint(args.checkpoint, model)
    elif args.torch_checkpoint:
        from ..train.checkpoints import CheckpointManager
        CheckpointManager.load_params(args.torch_checkpoint, model,
                                      use_ema=args.use_ema)
    dev = next(model.parameters()).device
    ds = build_dataset(args.split, cfg.data)
    loader = DataLoader(ds, 1, shuffle=False, drop_last=False)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    n = 0
    it = loader.epoch(0)
    try:
        for batch in it:
            with torch.inference_mode():
                out = model(torch.as_tensor(batch["image"]).to(dev))
                # visualization scales boxes to the post-resize content size
                # (visualize_prediction.py feeds `size`, not orig_size)
                dets = postprocess(out, torch.as_tensor(batch["size"]).to(dev),
                                   args.score_threshold,
                                   cfg.eval.hw_swap_compat)
                dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                           dets["labels"], dets["keep"],
                                           args.nms_iou, class_aware=False)
            dets = {k: v[0].cpu().numpy() for k, v in dets.items()}
            keep = dets["keep"]
            gt = ((batch["boxes"][0], batch["valid"][0])
                  if args.draw_gt and "boxes" in batch else (None, None))
            img = render_overlay(batch["image"][0], batch["size"][0],
                                 dets["boxes"][keep], dets["labels"][keep],
                                 dets["scores"][keep], *gt)
            img.save(out_dir / f"{int(batch['image_id'][0])}.jpg")
            n += 1
            if args.max_images and n >= args.max_images:
                break
    finally:
        it.close()
        loader.close()
    print(f"wrote {n} visualizations to {out_dir}")
    return n


if __name__ == "__main__":
    main()
