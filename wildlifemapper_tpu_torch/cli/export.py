"""Export CLI of the PyTorch port: the detector's forward as a `.pt2`
program (compat/export.py); counterpart of wildlifemapper_tpu/cli/export.py.
Runs on the card, with the hand-written kernels (as `wm::` operators) on by
default (`--no_flash_attention` for the plain path); `--device cpu` exports
the plain path on the CPU. With --polymorphic_batch one program serves
every batch size.

Usage:
  python -m wildlifemapper_tpu_torch.cli.export --out model.pt2 \\
      [--checkpoint trained.pth | --torch_checkpoint best_checkpoint] \\
      [--polymorphic_batch] [--use_amp] [--content_size 768]

Serving (any process with torch and this package, no model code):
  from wildlifemapper_tpu_torch.compat.export import load_exported
  forward = load_exported("model.pt2")     # imports the wm:: operators
  out = forward(images)                    # {'pred_logits', 'pred_boxes'}
"""

from __future__ import annotations

import argparse

from .train import add_config_args, add_device_arg, config_from_args


def main(argv=None):
    p = add_config_args(argparse.ArgumentParser(__doc__))
    p.add_argument("--out", required=True, help="output program (.pt2)")
    p.add_argument("--export_batch", type=int, default=1)
    p.add_argument("--polymorphic_batch", action="store_true",
                   help="symbolic batch dim: one program, any batch size")
    p.add_argument("--torch_checkpoint", default=None,
                   help="a checkpoint file written by the port's trainer; "
                        "takes the place of the JAX CLI's "
                        "--orbax_checkpoint")
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    import torch

    from ..compat.export import save_exported
    from ..models import WildlifeMapper

    model = WildlifeMapper(
        cfg.model, generator=torch.Generator().manual_seed(cfg.train.seed),
        device=args.device).eval()
    if args.checkpoint:
        from ..compat.torch_convert import convert_checkpoint
        convert_checkpoint(args.checkpoint, model)
    elif args.torch_checkpoint:
        from ..train.checkpoints import CheckpointManager
        CheckpointManager.load_params(args.torch_checkpoint, model)

    batch = None if args.polymorphic_batch else args.export_batch
    path = save_exported(model, args.out, batch_size=batch,
                         img_size=cfg.model.img_size)
    print(f"exported -> {path} ("
          + ("polymorphic batch" if batch is None else f"batch={batch}")
          + ")")
    return path


if __name__ == "__main__":
    main()
