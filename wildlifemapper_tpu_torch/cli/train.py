"""Training CLI of the PyTorch port; counterpart of
wildlifemapper_tpu/cli/train.py, with its flags and defaults.

Behavioral parity target: wildlifemapper/train.py's argparse surface
(train.py:46-115) mapped onto the typed Config; plus flags the reference
hardcodes (ce weight, queries, resize, canvas, hfc rate, image dirs).
Trains on the card. `--checkpoint` reads a reference .pth (SAM or a trained
WildlifeMapper) through compat/torch_convert.py; `--model_parallel P` splits
the model over groups of P ranks (parallel/mesh.py), the rest of the world
being the data axis.

Usage:
  python -m wildlifemapper_tpu_torch.cli.train --synthetic_data \
      --synthetic_size 1024 --use_amp [--model_type vit_b] [--epochs 550] \
      [--batch_size 6] ...
  torchrun --nproc_per_node N -m wildlifemapper_tpu_torch.cli.train ...
      (data-parallel over N cards, one process each; --batch_size is each
      data rank's)
  torchrun --nproc_per_node N -m wildlifemapper_tpu_torch.cli.train \
      --model_parallel P ...
      (N / P data ranks x P model ranks: each model group of P cards holds
      one model, split by heads and hidden widths, and takes the same rows)
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import (Config, DataConfig, EvalConfig,
                      MatchCriterionConfig, MeshConfig, TrainConfig,
                      model_config)


def add_config_args(p: argparse.ArgumentParser):
    p.add_argument("--model_type", default="vit_b",
                   choices=["vit_b", "vit_l", "vit_h"])
    p.add_argument("--coco_path", default=DataConfig().coco_path,
                   help="directory of {train,val,test}.json (default: the "
                        "vendored Mara-Wildlife / HerdNet bundle)")
    p.add_argument("--image_root", default="")
    p.add_argument("--synthetic_data", action="store_true",
                   help="use generated tiles when image files are absent")
    p.add_argument("--checkpoint", default=None,
                   help="torch .pth init (SAM or trained WM)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--work_dir", default="checkpoints")
    # optimization (reference defaults, train.py:62-101)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=550)
    p.add_argument("--lr_drop", type=int, default=40)
    p.add_argument("--clip_max_norm", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint_every", type=int, default=40,
                   help="save checkpoint_epoch_N every N epochs "
                        "(reference cadence 40, train.py:330)")
    p.add_argument("--eval_every", type=int, default=1,
                   help="run val evaluation every N epochs (always on the "
                        "final epoch); the reference evaluates every epoch")
    p.add_argument("--best_every", type=int, default=1,
                   help="consider a best_checkpoint write at most every N "
                        "epochs (1 = reference parity: best-by-train-loss "
                        "checked every epoch); >1 saves device->host state "
                        "fetch time on remote-device runs")
    p.add_argument("--best_metric", default="train_loss",
                   choices=["train_loss", "val_ap"],
                   help="best_checkpoint selector: train_loss = reference "
                        "parity (lowest epoch train loss, "
                        "train.py:357-368); val_ap = highest val COCO AP "
                        "(updates only on eval epochs)")
    p.add_argument("--train_encoder", action="store_true",
                   help="unfreeze the ViT encoder. The reference hardcodes "
                        "freezing (build_sam.py) because it always starts "
                        "from pretrained SAM; from-scratch runs MUST set "
                        "this or the encoder stays random")
    p.add_argument("--use_amp", action="store_true",
                   help="bf16 compute (the reference's flag is inert; ours works)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps (not in reference)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA of trainable params, 0=off (not in reference)")
    # matcher / criterion (train.py:72-85)
    p.add_argument("--set_cost_class", type=float, default=1)
    p.add_argument("--set_cost_bbox", type=float, default=5)
    p.add_argument("--set_cost_giou", type=float, default=2)
    p.add_argument("--ce_loss_coef", type=float, default=3)
    p.add_argument("--bbox_loss_coef", type=float, default=5)
    p.add_argument("--giou_loss_coef", type=float, default=2)
    p.add_argument("--eos_coef", type=float, default=0.1)
    p.add_argument("--max_targets", type=int, default=None,
                   help="fixed padded target count per image; default sizes "
                        "it from the annotation file so no GT is dropped")
    # data/aug
    p.add_argument("--resize_size", type=int, default=768)
    p.add_argument("--canvas_size", type=int, default=1024)
    p.add_argument("--synthetic_size", type=int, default=None,
                   help="render synthetic tiles at this size instead of the "
                        "annotation file's dims (annotations and eval GT are "
                        "rescaled to match) — scaled-down proxy runs")
    p.add_argument("--flip_prob", type=float, default=0.5)
    p.add_argument("--true_horizontal_flip", action="store_true",
                   help="fix the reference's vertical-flip quirk")
    p.add_argument("--mosaic", action="store_true")
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--device_normalize", action="store_true",
                   help="ship uint8 canvases and normalize inside the "
                        "step on the card (4x less host->device transfer)")
    p.add_argument("--worker_mode", choices=["thread", "process"],
                   default="thread",
                   help="loader worker pool; 'process' (spawned workers) "
                        "gives full parallelism for augmentation on "
                        "multi-core hosts")
    # model knobs the reference hardcodes
    p.add_argument("--num_queries", type=int, default=51)
    p.add_argument("--aux_loss", action="store_true",
                   help="deep supervision on intermediate decoder layers "
                        "(reference train.py:67 defaults this True but its "
                        "BoxDecoder is built with aux_loss=False — "
                        "box_decoder.py:26 — so the reference never "
                        "computes it; functional here, adds no params)")
    p.add_argument("--hfc_rate", type=float, default=0.125)
    p.add_argument("--no_flash_attention", action="store_true")
    p.add_argument("--content_size", type=int, default=None,
                   help="content-crop fast path: run the ViT blocks on the "
                        "content grid only (e.g. 768 for the standard "
                        "768-in-1024 canvas); None = reference behavior")
    p.add_argument("--window_size", type=int, default=None,
                   help="windowed-attention window (default: the variant's "
                        "14). 12 tiles the 48x48 content grid exactly — the "
                        "production from-scratch choice (PERF.md); SAM init "
                        "center-slices the rel-pos tables")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize ViT blocks in the backward "
                        "(torch.utils.checkpoint): ~1 extra block-forward of "
                        "FLOPs for O(1) stored activations — fits ViT-L/H "
                        "training batches in device memory")
    p.add_argument("--crop_prologue", action="store_true",
                   help="from-scratch mode: HFC/patch-embeds/adaptor also "
                        "run at content_size (implies "
                        "--fix_scrambled_reshape; requires --content_size)")
    p.add_argument("--fix_scrambled_reshape", action="store_true",
                   help="fix the reference's no-transpose adaptor reshape "
                        "(image_encoder.py:512); breaks released-checkpoint "
                        "compatibility, use when training from scratch")
    # eval
    p.add_argument("--confidence_threshold", type=float, default=0.05)
    p.add_argument("--fix_hw_swap", action="store_true",
                   help="fix the reference's PostProcess h/w swap")
    # parallelism
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallelism: split the model over groups of "
                        "this many ranks (torchrun with a multiple of it); "
                        "the evaluation CLIs run one process unsplit")
    # logging
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", default="wildlifemapper-tpu")
    p.add_argument("--log_histograms_every", type=int, default=0,
                   help="param-histogram cadence in epochs (0=off); the "
                        "wandb model-watch equivalent")
    p.add_argument("--run_name", default=None)
    return p


def add_device_arg(p: argparse.ArgumentParser):
    """The port's own flag beside the shared ones: where the model runs."""
    p.add_argument("--device", default=None,
                   help="torch device; default the card (raises without "
                        "CUDA), 'cpu' to run on the CPU")
    return p


def config_from_args(args) -> Config:
    model = model_config(
        args.model_type,
        dtype="bfloat16" if args.use_amp else "float32",
        use_flash_attention=not args.no_flash_attention)
    fix_scramble = (getattr(args, "fix_scrambled_reshape", False)
                    or getattr(args, "crop_prologue", False))
    vit = model.vit
    if getattr(args, "window_size", None):
        vit = dataclasses.replace(vit, window_size=args.window_size)
    model = dataclasses.replace(
        model,
        vit=vit,
        img_size=args.canvas_size,
        content_size=getattr(args, "content_size", None),
        crop_prologue=getattr(args, "crop_prologue", False),
        remat_blocks=getattr(args, "remat", False),
        hfc=dataclasses.replace(
            model.hfc, rate=args.hfc_rate,
            compat_scrambled_reshape=not fix_scramble),
        decoder=dataclasses.replace(model.decoder,
                                    num_queries=args.num_queries,
                                    aux_loss=getattr(args, "aux_loss",
                                                     False)))
    return Config(
        model=model,
        criterion=MatchCriterionConfig(
            set_cost_class=args.set_cost_class,
            set_cost_bbox=args.set_cost_bbox,
            set_cost_giou=args.set_cost_giou,
            ce_loss_coef=args.ce_loss_coef,
            bbox_loss_coef=args.bbox_loss_coef,
            giou_loss_coef=args.giou_loss_coef,
            eos_coef=args.eos_coef,
            max_targets=args.max_targets or 128),
        data=DataConfig(
            coco_path=args.coco_path, image_root=args.image_root,
            resize_size=args.resize_size, canvas_size=args.canvas_size,
            flip_prob=args.flip_prob,
            flip_is_vertical=not args.true_horizontal_flip,
            use_mosaic=args.mosaic, max_targets=args.max_targets,
            batch_size=args.batch_size, synthetic=args.synthetic_data,
            synthetic_size=getattr(args, "synthetic_size", None),
            num_workers=getattr(args, "num_workers", 2),
            worker_mode=getattr(args, "worker_mode", "thread"),
            device_normalize=getattr(args, "device_normalize", False)),
        train=TrainConfig(
            lr=args.lr, weight_decay=args.weight_decay, epochs=args.epochs,
            lr_drop=args.lr_drop, clip_max_norm=args.clip_max_norm,
            seed=args.seed, use_amp=args.use_amp,
            freeze_encoder=not getattr(args, "train_encoder", False),
            eval_every=getattr(args, "eval_every", 1),
            best_every=getattr(args, "best_every", 1),
            best_metric=getattr(args, "best_metric", "train_loss"),
            checkpoint_every=getattr(args, "checkpoint_every", 40),
            warmup_steps=args.warmup_steps, ema_decay=args.ema_decay,
            log_histograms_every=args.log_histograms_every),
        eval=EvalConfig(confidence_threshold=args.confidence_threshold,
                        hw_swap_compat=not args.fix_hw_swap),
        mesh=MeshConfig(model_parallel_size=args.model_parallel),
    )


def main(argv=None, watch=None):
    """Train from the command line `argv`; `watch`, a
    train.profiling.StepWatch, clocks the loop's steps on the card. Under
    torchrun each rank joins the process group on its own card (LOCAL_RANK)
    and the run is data-parallel over the data ranks, tensor-parallel over
    groups of --model_parallel ranks."""
    p = add_config_args(argparse.ArgumentParser(__doc__))
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    from ..parallel import distributed as dist
    from ..train.logging import NoOpLogger, setup_logger
    from ..train.loop import train

    distributed = dist.init_distributed_mode(device=args.device)
    if distributed:
        dist.setup_for_distributed(dist.is_main_process())
    logger = (setup_logger(args.use_wandb, args.work_dir, config=cfg,
                           project=args.wandb_project,
                           run_name=args.run_name)
              if dist.is_main_process() else NoOpLogger())
    try:
        stats = train(cfg, workdir=args.work_dir, logger_backend=logger,
                      resume=args.resume, init_checkpoint=args.checkpoint,
                      device=args.device, watch=watch, print_fn=print)
        logger.log_summary(stats)
    finally:
        logger.finish()
        if distributed:
            import torch.distributed
            torch.distributed.destroy_process_group()
    return stats


if __name__ == "__main__":
    main()
