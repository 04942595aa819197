"""The full training loop; counterpart of wildlifemapper_tpu/train/loop.py.

Behavioral parity target: train.py:184-372 — epoch loop with per-iteration
logging, NaN guard, per-epoch evaluation, StepLR, periodic + best
checkpoints, optional wandb-style logging.

On the card a loop step waits for the device twice: once in the step, where
the matching cost crosses to the host (ops/lsap.py), and once where the host
reads the previous step's metrics, which are complete by then (they crossed
to pinned host memory behind their step). The batch comes from pinned host
memory and its copy does not wait.

Over a process group (parallel/distributed.py) every rank runs this loop on
its own card with its data rank's shard of each epoch (the loaders'
process_index / process_count over the data group) through the
data-parallel step; the meters and the evaluation's detections are merged
over the data group, and only rank 0 writes config.json, the best tracker
and the checkpoints. Under tensor parallelism (cfg.mesh.model_parallel_size
P > 1) the P ranks of a model group take the same rows, draw the same
dropout masks and hold one model between them.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..compat.torch_convert import convert_checkpoint
from ..config import Config, config_to_json
from ..data.loader import DataLoader, build_dataset
from ..eval.evaluate import evaluate, to_device, to_host
from ..models.detector import resolve_device
from ..parallel.distributed import (get_data_rank, get_data_world_size,
                                    get_rank)
from ..parallel.mesh import make_mesh
from ..weights import load_reference_state_dict
from .checkpoints import CheckpointManager, state_tree
from .metrics import MetricLogger
from .profiling import StepWatch
from .step import StepBuilder

# what a train step reads of a batch
TRAIN_KEYS = ("image", "labels", "boxes", "valid", "size")


def train(cfg: Config, workdir: str = "checkpoints",
          epochs: Optional[int] = None, logger_backend=None, print_fn=print,
          resume: bool = False, max_steps_per_epoch: Optional[int] = None,
          max_eval_batches: Optional[int] = None,
          device: Union[None, str, torch.device] = None,
          init_checkpoint: Optional[str] = None,
          init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          watch: Optional[StepWatch] = None) -> Dict[str, float]:
    """Run training; returns the last epoch's stats (train/..., val/...).

    The model is built on the card unless `device` says otherwise, its
    parameters drawn from `cfg.train.seed`, or taken from `init_state_dict`
    (a state dict in the reference's names, as weights.py converts them),
    or from `init_checkpoint`, the reference's .pth (SAM or a trained
    WildlifeMapper) through compat/torch_convert.py, whose missing entries
    keep their drawn values. `watch` clocks the steps and evaluations on the
    card. In a process group (parallel/distributed.py) the run is
    data-parallel over the data group, each rank on its current card, and
    with cfg.mesh.model_parallel_size above 1 tensor-parallel over each
    model group."""
    device = resolve_device(device)
    epochs = epochs if epochs is not None else cfg.train.epochs
    make_mesh(cfg.mesh.model_parallel_size)      # the grid the loop reads
    rank, ranks = get_data_rank(), get_data_world_size()

    train_ds = build_dataset("train", cfg.data)
    val_ds = build_dataset("val", cfg.data)
    if cfg.data.max_targets is None:
        # Reflect the annotation-file-resolved cap back into the config so
        # the config.json written beside checkpoints records the run's
        # actual padded target width (criterion.max_targets kept in sync).
        resolved = train_ds.preprocess.max_targets
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, max_targets=resolved),
            criterion=dataclasses.replace(cfg.criterion,
                                          max_targets=resolved))
    pin = device.type == "cuda"
    train_loader = DataLoader(
        train_ds, cfg.data.batch_size, shuffle=True, seed=cfg.train.seed,
        drop_last=True, process_index=rank, process_count=ranks,
        num_workers=cfg.data.num_workers, worker_mode=cfg.data.worker_mode,
        pin_memory=pin)
    val_loader = DataLoader(val_ds, cfg.data.batch_size, shuffle=False,
                            drop_last=False, process_index=rank,
                            process_count=ranks, pin_memory=pin)
    try:
        steps_per_epoch = train_loader.batches_per_epoch()
        if max_steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

        builder = StepBuilder(
            cfg, generator=torch.Generator().manual_seed(cfg.train.seed),
            device=device)
        if init_state_dict is not None:
            load_reference_state_dict(builder.model, init_state_dict)
        if init_checkpoint:
            report = convert_checkpoint(init_checkpoint, builder.model)
            print_fn(f"loaded {len(report['loaded'])} tensors from "
                     f"{init_checkpoint}; kept init for "
                     f"{len(report['missing'])}")
        state = builder.init_state(steps_per_epoch)
        ckpt = CheckpointManager(workdir)
        if get_rank() == 0:
            # Persist the exact Config beside the checkpoints so evaluation
            # can rebuild a from-scratch run without its flags.
            (Path(workdir) / "config.json").write_text(config_to_json(cfg))
        # the adaptor's dropout draws from a generator on the card, one seed
        # a data rank (a model group's ranks draw the same masks), saved and
        # restored with the checkpoints so a resumed run draws what an
        # unbroken one draws
        dropout_gen = torch.Generator(device=device).manual_seed(
            cfg.train.seed + 1 + rank)
        start_epoch = 0
        if resume and ckpt.latest_epoch() is not None:
            ep = ckpt.latest_epoch()
            state = ckpt.restore(f"checkpoint_epoch_{ep}", state, dropout_gen)
            start_epoch = ep + 1
            print_fn(f"resumed from epoch {ep}")

        # The tracked best survives process restarts (segmented runs): it is
        # persisted beside the checkpoints, else a resumed process would start
        # at inf and overwrite best_checkpoint with its first (possibly worse)
        # epoch. best_metric="train_loss" is reference parity
        # (train.py:357-368); "val_ap" keeps the highest val COCO AP instead.
        maximize = cfg.train.best_metric == "val_ap"
        best_value = float("-inf") if maximize else float("inf")
        best_file = Path(workdir) / "best_loss.json"
        if resume and best_file.exists():
            saved = json.loads(best_file.read_text())
            if saved.get("metric", "train_loss") == cfg.train.best_metric:
                # legacy files carry only {"loss": ...}
                best_value = saved.get("value", saved.get("loss"))
                # the exact legacy message for the default metric: log parsers
                # match "resumed best_loss="
                tag = ("best_loss" if cfg.train.best_metric == "train_loss"
                       else f"best_{cfg.train.best_metric}")
                print_fn(f"resumed {tag}={best_value:.4f}")
            else:
                print_fn(f"best metric changed "
                         f"({saved.get('metric', 'train_loss')} -> "
                         f"{cfg.train.best_metric}); best tracker reset")
        stats: Dict[str, float] = {}
        for epoch in range(start_epoch, epochs):
            logger = MetricLogger(print_fn=print_fn)
            t0 = time.time()
            it = train_loader.epoch(epoch)

            def consume(step_j, pending):
                host, done = pending
                if done is not None:
                    done.synchronize()
                metrics = {k: float(v) for k, v in host.items()}
                if not np.isfinite(metrics["loss"]):
                    # reference: print + sys.exit(1) on non-finite loss
                    # (train.py:285-288); with the one-step-delayed fetch the
                    # guard trips one step later than the reference's.
                    print_fn(f"Loss is {metrics['loss']}, stopping training")
                    sys.exit(1)
                logger.update(**metrics)
                if logger_backend and step_j % 50 == 0:
                    logger_backend.log_batch(epoch, step_j, metrics)

            # Metrics are read one step behind: each step's cross to the host
            # behind it without a wait, and step i-1's are complete when the
            # host reads them after step i (whose matching waited for the
            # card past them), so the read waits for nothing of step i.
            pending = None
            try:
                for step_i, batch in enumerate(
                        logger.log_every(it, 50, header=f"Epoch: [{epoch}]",
                                         total=steps_per_epoch)):
                    if step_i >= steps_per_epoch:
                        break
                    arrays = to_device(batch, TRAIN_KEYS, device)
                    if watch is None:
                        state, metrics_dev = builder.train_step(
                            state, arrays, dropout_gen)
                    else:
                        state, metrics_dev = watch.train_step(
                            builder, state, arrays, dropout_gen)
                    if pending is not None:
                        consume(step_i - 1, pending)
                    pending = to_host(metrics_dev)
                if pending is not None:
                    consume(steps_per_epoch - 1, pending)
            finally:
                it.close()

            logger.synchronize_between_processes()
            epoch_stats = logger.global_averages()
            epoch_loss = epoch_stats.get("loss", float("inf"))
            print_fn(f"Epoch {epoch} done in {time.time()-t0:.1f}s  "
                     f"loss={epoch_loss:.4f}")

            run_eval = (cfg.train.eval_every <= 1
                        or (epoch + 1) % cfg.train.eval_every == 0
                        or epoch == epochs - 1)
            val_stats = {}
            if run_eval:
                run = evaluate if watch is None else functools.partial(
                    watch.evaluate, evaluate)
                val_stats = run(builder.eval_step, state.model, val_loader,
                                val_ds.index, cfg, epoch=epoch,
                                print_fn=print_fn,
                                max_batches=max_eval_batches,
                                logger_backend=logger_backend)
            stats = {**{f"train/{k}": v for k, v in epoch_stats.items()},
                     **{f"val/{k}": v for k, v in val_stats.items()}}
            if logger_backend:
                logger_backend.log_epoch(epoch, stats)

            if (logger_backend and cfg.train.log_histograms_every
                    and epoch % cfg.train.log_histograms_every == 0):
                # wandb model-watch equivalent (wandb_logger.py:101-120, 272-288)
                logger_backend.log_histograms(
                    epoch, {k: p.detach().cpu()
                            for k, p in state.model.named_parameters()})

            if maximize:
                candidate = val_stats.get("coco/AP")
                is_best = candidate is not None and candidate > best_value
            else:
                candidate = epoch_loss
                is_best = candidate < best_value
            if is_best:
                best_value = candidate
            if is_best and get_rank() == 0:
                # "loss" key kept for segmented-run readers of older files
                best_file.write_text(json.dumps(
                    {"loss": epoch_loss, "epoch": epoch,
                     "metric": cfg.train.best_metric, "value": best_value}))
            # best_every > 1 rate-limits best_checkpoint writes; the best epoch
            # since the last allowed save still wins because best_loss tracks
            # every epoch.
            allow_best = ((epoch + 1) % max(cfg.train.best_every, 1) == 0
                          or epoch == epochs - 1)
            ckpt.save_epoch(epoch, lambda: state_tree(state, dropout_gen),
                            every=cfg.train.checkpoint_every,
                            is_best=is_best and allow_best,
                            force_epoch=epoch == epochs - 1)
            if is_best and logger_backend:
                # best-checkpoint artifact (wandb_logger.py:306-329)
                logger_backend.log_artifact(
                    str(ckpt._path("best_checkpoint")), "best_checkpoint",
                    type="model", metadata={"epoch": epoch, "loss": epoch_loss,
                                            cfg.train.best_metric: best_value})

        return stats
    finally:
        train_loader.close()
        val_loader.close()
