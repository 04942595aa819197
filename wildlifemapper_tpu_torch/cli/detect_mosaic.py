"""Orthomosaic detection CLI of the PyTorch port: run the sliding-window
detector over one or more large aerial images on the card; counterpart of
wildlifemapper_tpu/cli/detect_mosaic.py, with its flags and JSON output.

Usage:
  python -m wildlifemapper_tpu_torch.cli.detect_mosaic --images a.jpg b.tif \\
      --checkpoint best_checkpoint.pth --output detections.json
  torchrun --nproc_per_node N -m wildlifemapper_tpu_torch.cli.detect_mosaic \\
      ...   (each frame's tile batches split over N cards; rank 0 writes)

Weights come from `--checkpoint` (a reference .pth: SAM or a trained
WildlifeMapper); without it the model keeps seeded random weights. Decoding
an image file needs PIL.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.transforms import decode_image
from .train import add_config_args, add_device_arg, config_from_args


def decode_mosaic(path) -> np.ndarray:
    """An image file -> uint8 (H, W, 3) RGB, with PIL's decompression cap
    lifted (orthomosaics exceed it); PIL imported here."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None
    return decode_image(path)


def main(argv=None):
    p = add_config_args(argparse.ArgumentParser(__doc__))
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--output", default="mosaic_detections.json")
    p.add_argument("--tile_batch", type=int, default=4)
    p.add_argument("--overlap", type=int, default=256)
    p.add_argument("--score_threshold", type=float, default=0.5)
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    import torch

    from ..eval.orthomosaic import OrthomosaicDetector
    from ..models import WildlifeMapper
    from ..parallel import distributed as dist

    distributed = dist.init_distributed_mode(device=args.device)
    if distributed:
        dist.setup_for_distributed(dist.is_main_process())
    model = WildlifeMapper(cfg.model, generator=torch.Generator().manual_seed(0),
                           device=args.device).eval()
    if args.checkpoint:
        from ..compat.torch_convert import convert_checkpoint
        convert_checkpoint(args.checkpoint, model)
    det = OrthomosaicDetector(model, cfg.model, tile_batch=args.tile_batch,
                              overlap=args.overlap,
                              confidence_threshold=args.score_threshold,
                              nms_iou=cfg.eval.nms_iou)
    results = {}
    for path in args.images:
        img = decode_mosaic(path)
        out = det.detect(img)
        results[Path(path).name] = {
            "boxes": out["boxes"].tolist(),
            "scores": out["scores"].tolist(),
            "labels": out["labels"].tolist(),
        }
        print(f"{path}: {len(out['boxes'])} detections over "
              f"{img.shape[1]}x{img.shape[0]} px")
    if dist.is_main_process():
        with open(args.output, "w") as f:
            json.dump(results, f)
        print(f"wrote {args.output}")
    if distributed:
        torch.distributed.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
