"""Checkpointing (save / resume / best tracking); counterpart of
wildlifemapper_tpu/train/checkpoints.py, with torch.save in place of orbax.

Behavioral parity target: the reference saves {model, optimizer, epoch}
every 40 epochs plus best_checkpoint.pth by lowest epoch train loss
(train.py:344-372); resume restores the model and start_epoch
(train.py:236-245). Here a checkpoint is one file holding everything a run
needs to continue as if unbroken: the model's state dict (the reference's
names), the optimizer's (Adam's moments and counts) and the scheduler's,
`step`, the EMA parameters, and the state of the generator that draws the
adaptor's dropout (every rank's, over a process group). It is written to a
temporary file and renamed, so a crash leaves no half checkpoint.

Over a process group only rank 0 writes, as in the JAX package, and every
rank reads; each save ends in a barrier, so no rank resumes from a file that
rank 0 is still writing. Under tensor parallelism a checkpoint keeps the
one-process format: the model's, Adam's and the EMA's shards are gathered
over the model group before rank 0 writes, and a restore cuts the whole
state to this rank's shard, so a run resumes at any model axis, as orbax
lets the JAX package's. The dropout generators are the data ranks' (the
ranks of one model group draw the same masks).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..parallel.distributed import (all_gather_objects, barrier,
                                    data_group, get_data_rank,
                                    get_data_world_size, is_main_process)
from .step import TrainState


def _param_names(state: TrainState):
    """The name of each of the optimizer's parameter indices."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups
            for p in g["params"]]


def state_tree(state: TrainState,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """What a checkpoint holds for `state` (and the dropout generator:
    over a data axis, the list of every data rank's, gathered here, so every
    rank calls this). The tensors are the live ones: nothing is copied from
    the card until a save writes them; under tensor parallelism they are
    the whole model's, gathered over the model group."""
    gen = generator.get_state() if generator is not None else None
    if gen is not None and get_data_world_size() > 1:
        gen = all_gather_objects(gen, data_group())
    model = state.model.state_dict()
    optimizer = state.optimizer.state_dict()
    ema = state.ema_params
    shards = state.model_parallel
    if shards is not None:
        model = shards.gather(model)
        optimizer = shards.gather_opt_state(optimizer, _param_names(state))
        if ema is not None:
            ema = shards.gather(ema)
    return {
        "model": model,
        "optimizer": optimizer,
        "scheduler": state.scheduler.state_dict(),
        "step": int(state.step),
        "ema_params": ema,
        "generator": gen,
    }


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, name) -> Path:
        return self.directory / str(name)

    def save(self, name, tree: Dict[str, Any], force: bool = True):
        """torch.save `tree` under `name` on rank 0, through a temporary
        file and a rename; `force=False` leaves an existing checkpoint
        alone. Every rank calls it and leaves it when the file is whole."""
        if is_main_process():
            path = self._path(name)
            if force or not path.exists():
                tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
                torch.save(tree, tmp)
                os.replace(tmp, path)
        barrier()

    def load(self, name) -> Dict[str, Any]:
        return torch.load(self._path(name), map_location="cpu",
                          weights_only=True)

    def restore(self, name, target: TrainState,
                generator: Optional[torch.Generator] = None) -> TrainState:
        """Load checkpoint `name` into `target` (its model, optimizer and
        scheduler, in place) and `generator`; returns `target`. Under
        tensor parallelism the whole state is cut to this rank's shard."""
        raw = self.load(name)
        model, optimizer, ema = raw["model"], raw["optimizer"], \
            raw["ema_params"]
        shards = target.model_parallel
        if shards is not None:
            model = shards.shard(model)
            optimizer = shards.shard_opt_state(optimizer,
                                               _param_names(target))
            if ema is not None:
                ema = shards.shard(ema)
        target.model.load_state_dict(model)
        target.optimizer.load_state_dict(optimizer)
        target.scheduler.load_state_dict(raw["scheduler"])
        target.step = int(raw["step"])
        if ema is not None:
            dev = next(target.model.parameters()).device
            target.ema_params = {k: v.to(dev) for k, v in ema.items()}
        gen = raw["generator"]
        if generator is not None and gen is not None:
            if isinstance(gen, list):     # one state a data rank
                rank = get_data_rank()
                if rank >= len(gen):
                    raise ValueError(
                        f"{name} holds the dropout generators of "
                        f"{len(gen)} data ranks; this is data rank {rank}")
                gen = gen[rank]
            generator.set_state(gen)
        return target

    def exists(self, name) -> bool:
        return self._path(name).exists()

    def save_epoch(self, epoch: int,
                   state_tree: Union[Dict[str, Any],
                                     Callable[[], Dict[str, Any]]],
                   every: int = 40, is_best: bool = False,
                   force_epoch: bool = False):
        """Reference cadence: every N epochs + best-by-train-loss.

        `state_tree` may be a zero-arg callable returning the tree — it is
        only invoked when a save actually fires, so the epochs that save
        nothing copy nothing from the card.

        `force_epoch` writes the epoch checkpoint regardless of cadence —
        the loop sets it on the final epoch so a follow-up invocation with
        a higher epoch target resumes exactly where this one stopped.

        Over a process group every rank calls it with the same arguments."""
        epoch_due = (epoch + 1) % every == 0 or force_epoch
        if not (epoch_due or is_best):
            return
        if callable(state_tree):
            state_tree = state_tree()
        if epoch_due:
            self.save(f"checkpoint_epoch_{epoch}", state_tree)
        if is_best:
            self.save("best_checkpoint", state_tree)

    @staticmethod
    def load_params(path: str, model: torch.nn.Module,
                    use_ema: bool = False) -> torch.nn.Module:
        """Load inference weights into `model` from a checkpoint file that
        holds either a full train state (what the trainer saves) or a bare
        state dict. With `use_ema` the EMA parameters replace the raw ones
        (with a warning when the checkpoint has none). The load is strict,
        so a topology mismatch fails loudly."""
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if "optimizer" in raw:   # a train state; a bare state dict has none
            sd = dict(raw["model"])
            has_ema = raw.get("ema_params") is not None
            if use_ema and not has_ema:
                import warnings
                warnings.warn(
                    f"use_ema=True but checkpoint {path} carries no EMA "
                    "tree (trained with ema_decay=0?); falling back to raw "
                    "params", RuntimeWarning, stacklevel=2)
            if use_ema and has_ema:
                sd.update(raw["ema_params"])
        else:
            sd = raw
        model.load_state_dict(sd)
        return model

    def latest_epoch(self) -> Optional[int]:
        epochs = []
        for p in self.directory.glob("checkpoint_epoch_*"):
            try:
                epochs.append(int(p.name.rsplit("_", 1)[1]))
            except ValueError:
                pass
        return max(epochs) if epochs else None
