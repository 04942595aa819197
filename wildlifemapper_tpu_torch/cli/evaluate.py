"""Standalone evaluation CLI of the PyTorch port: COCO mAP on a split with a
checkpoint the port's trainer wrote; counterpart of
wildlifemapper_tpu/cli/evaluate.py. Runs on the card.

Usage:
  python -m wildlifemapper_tpu_torch.cli.evaluate --synthetic_data \\
      --synthetic_size 1024 --use_amp --config_json checkpoints/config.json \\
      --torch_checkpoint checkpoints/best_checkpoint [--split val] [--nms]
  python -m wildlifemapper_tpu_torch.cli.evaluate --checkpoint best.pth
      (a reference .pth: SAM or a trained WildlifeMapper)

It evaluates in one process with the model whole, as the JAX package's
evaluate CLI does (it builds no mesh): --model_parallel is parsed with the
trainer's flags and does not split the model. A checkpoint written by a
tensor-parallel run holds the whole model.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import MeshConfig
from .train import add_config_args, add_device_arg, config_from_args


def main(argv=None):
    p = add_config_args(argparse.ArgumentParser(__doc__))
    p.add_argument("--split", default="val", choices=["train", "val", "test"])
    p.add_argument("--torch_checkpoint", default=None,
                   help="a checkpoint file written by the port's trainer "
                        "(train/checkpoints.py: checkpoint_epoch_N or "
                        "best_checkpoint under --work_dir); takes the place "
                        "of the JAX CLI's --orbax_checkpoint")
    p.add_argument("--nms", action="store_true",
                   help="apply NMS 0.4 (the viz path's setting)")
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA weights of --torch_checkpoint")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--config_json", default=None,
                   help="config.json written by the trainer beside its "
                        "checkpoints; overrides the flag-derived model "
                        "config so from-scratch runs (crop_prologue, "
                        "window 12, ...) evaluate with the exact trained "
                        "architecture")
    add_device_arg(p)
    args = p.parse_args(argv)
    # one process, the model whole, whatever --model_parallel says
    cfg = dataclasses.replace(config_from_args(args), mesh=MeshConfig())
    if args.config_json:
        from ..config import config_from_json
        with open(args.config_json) as f:
            saved = config_from_json(f.read())
        cfg = dataclasses.replace(cfg, model=saved.model,
                                  criterion=saved.criterion)

    import torch

    from ..data.loader import DataLoader, build_dataset
    from ..eval.evaluate import evaluate
    from ..train.checkpoints import CheckpointManager
    from ..train.step import StepBuilder

    ds = build_dataset(args.split, cfg.data)
    builder = StepBuilder(cfg, generator=torch.Generator().manual_seed(0),
                          device=args.device)
    loader = DataLoader(ds, cfg.data.batch_size, shuffle=False,
                        drop_last=False,
                        pin_memory=builder.device.type == "cuda")
    if args.checkpoint:
        from ..compat.torch_convert import convert_checkpoint
        report = convert_checkpoint(args.checkpoint, builder.model)
        print(f"loaded {len(report['loaded'])} tensors "
              f"({len(report['missing'])} kept at init)")
    elif args.torch_checkpoint:
        CheckpointManager.load_params(args.torch_checkpoint, builder.model,
                                      use_ema=args.use_ema)
    try:
        stats = evaluate(builder.eval_step, builder.model, loader, ds.index,
                         cfg, apply_nms=args.nms,
                         max_batches=args.max_batches)
    finally:
        loader.close()
    for k, v in stats.items():
        print(f"{k}: {v:.4f}")
    return stats


if __name__ == "__main__":
    main()
