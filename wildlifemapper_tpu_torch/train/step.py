"""Train and eval steps; counterpart of wildlifemapper_tpu/train/step.py.

One train step is forward, set criterion with the Hungarian match, backward,
clip, AdamW update and EMA (reference train.py:261-312). With
`use_flash_attention` the forward and the backward of the ViT blocks and of
the adaptor's attention run the hand-written kernels (ops/). bf16 training is
`cfg.model.dtype = "bfloat16"` with f32 parameters, computed exactly as the
serving path computes it: there is no autocast, every layer casts its own
parameters.

A step synchronises with the host once, in the criterion, where the matching
cost crosses to scipy (ops/lsap.py); once more for each aux layer. The
metrics stay on the device until the caller reads them.

Over the data axis (the data group of parallel/mesh.py: the default
process group without a model axis) each rank runs the step on its own
rows: the forward goes through DistributedDataParallel over the data group,
which averages the gradients over its ranks inside the backward, and the
criterion normalises over the global batch of the data group, so that clip,
AdamW and EMA see the gradient of the global loss and stay identical on
every rank of the group (the JAX step over an N-way data axis). The eval
step runs the bare model.

Over a model axis (`cfg.mesh.model_parallel_size` P > 1, the JAX
`StepBuilder(cfg, mesh=make_mesh(P), use_tp=True)` step) `init_state` splits
the model (parallel/mesh.py::shard_model) before it builds the optimizer:
each rank holds its shard of every split pair, so AdamW's moments and the
EMA follow their parameters' shards, and the clip's norm is the whole
model's. The model ranks of a data group take the same rows, compute the
same loss and keep their whole parameters in lock step.

Frozen parameters (the freeze policy of train/optimizer.py) have
requires_grad False, so autograd skips their weight-gradient products while
activation gradients still reach the trainable patch / HFC embeddings below
the 12 blocks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple, Union

import torch
from torch.nn.parallel import DistributedDataParallel

from ..config import Config
from ..models import WildlifeMapper
from ..models.detector import resolve_device
from ..parallel.mesh import (Mesh, ModelShards, data_axis, data_parallel,
                             make_mesh, shard_model)
from .criterion import set_criterion
from .optimizer import build_optimizer, clip_by_global_norm_


@dataclasses.dataclass
class TrainState:
    """What a step carries: the model's parameters live in `model`, Adam's
    moments in `optimizer`, the schedule's count in `scheduler`."""

    model: WildlifeMapper
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    # Exponential moving average of every parameter by name
    # (TrainConfig.ema_decay > 0); None when EMA is off.
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # `model` wrapped for the data axis, which the train step's forward goes
    # through; None on one process.
    data_parallel: Optional[DistributedDataParallel] = None
    # how `model` is split over the model axis; None without one
    model_parallel: Optional[ModelShards] = None


@functools.lru_cache(maxsize=8)
def _mean_std(mean, std, device: torch.device):
    """The normalisation constants cached on the device: a host copy per
    step would be one more stream synchronisation."""
    with torch.inference_mode(False):
        return (torch.tensor(mean, dtype=torch.float32, device=device),
                torch.tensor(std, dtype=torch.float32, device=device))


def device_normalize(images: torch.Tensor,
                     sizes: Optional[torch.Tensor] = None,
                     mean=(0.485, 0.456, 0.406),
                     std=(0.229, 0.224, 0.225)) -> torch.Tensor:
    """uint8 canvases (DataConfig.device_normalize: 4x less host-to-device
    traffic) -> ImageNet-normalised f32; float input passes through.

    The reference normalises before zero-padding, so the pad band must stay
    exactly 0.0 in normalised space: `sizes` (B, 2), the h/w content
    extents, re-zero it (black content pixels still become -mean/std)."""
    if images.dtype != torch.uint8:
        return images
    dev = images.device
    mean_t, std_t = _mean_std(tuple(mean), tuple(std), dev)
    x = (images.float() / 255.0 - mean_t) / std_t
    if sizes is not None:
        rows = torch.arange(images.shape[1], device=dev)[None, :, None, None]
        cols = torch.arange(images.shape[2], device=dev)[None, None, :, None]
        content = ((rows < sizes[:, 0, None, None, None])
                   & (cols < sizes[:, 1, None, None, None]))
        x = torch.where(content, x, torch.zeros_like(x))
    return x


class StepBuilder:
    """Builds the model and the train / eval steps for a Config, on the card
    unless the caller passes device="cpu" (as WildlifeMapper). Built in a
    process group, the train step is data-parallel over its data group, and
    with cfg.mesh.model_parallel_size P > 1 tensor-parallel over groups of
    P ranks (which needs a process group of a multiple of P ranks)."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None,
                 device: Union[None, str, torch.device] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # P = 1: the data axis, the default process group (None in one
        # process); P > 1: the grid of data x model ranks
        self.mesh = make_mesh(cfg.mesh.model_parallel_size)
        # the group the step is data-parallel over, None if it is not
        self.data_group = data_axis(self.mesh)
        self.model = WildlifeMapper(cfg.model, generator=generator,
                                    device=self.device)

    def init_state(self, steps_per_epoch: int) -> TrainState:
        """Split `self.model` over the model axis, if there is one, apply
        the freeze policy and build the optimizer, the schedule and the EMA
        copy around it (load whole weights into `self.model` first), and
        over the data axis the data-parallel wrapper, which takes the data
        group's first rank's parameters."""
        shards = (shard_model(self.model, self.mesh)
                  if isinstance(self.mesh, Mesh) else None)
        opt, sched = build_optimizer(self.model, self.cfg.train,
                                     steps_per_epoch)
        wrapped = (data_parallel(self.model, self.data_group)
                   if self.data_group is not None else None)
        ema = None
        if self.cfg.train.ema_decay > 0:
            ema = {k: p.detach().clone()
                   for k, p in self.model.named_parameters()}
        return TrainState(self.model, opt, sched, 0, ema, wrapped, shards)

    def images(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The batch's images as the model takes them (uint8 canvases are
        normalised on the device)."""
        data = self.cfg.data
        return device_normalize(batch["image"], batch.get("size"),
                                data.mean, data.std)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update in place. batch: image (B, H, W, 3) float normalised
        or uint8, optional size (B, 2), labels (B, T), boxes (B, T, 4)
        cxcywh, valid (B, T), all on the model's device. `generator` drives
        the adaptor's dropout (needed when hfc.dropout > 0) and must live on
        that device. Returns the state and the metrics (the criterion's
        dict plus grad_norm, the global norm of the trainable gradients
        before clipping), as 0-d tensors on the device; over the data axis,
        the batch is this rank's rows and the metrics are the global
        batch's."""
        cfg = self.cfg
        model = state.model
        forward = (model if state.data_parallel is None
                   else state.data_parallel)
        out = forward(self.images(batch), deterministic=False,
                      generator=generator)
        losses = set_criterion(out, batch, cfg.criterion,
                               num_classes=cfg.model.num_classes,
                               global_batch=self.data_group is not None)
        state.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()

        params = [p for g in state.optimizer.param_groups
                  for p in g["params"] if p.grad is not None]
        grad_norm = clip_by_global_norm_(
            [p.grad for p in params], cfg.train.clip_max_norm,
            [hasattr(p, "model_parallel_split") for p in params],
            None if state.model_parallel is None
            else state.model_parallel.mesh.model)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        if state.ema_params is not None:
            d = cfg.train.ema_decay
            with torch.no_grad():
                names, params = zip(*model.named_parameters())
                ema = [state.ema_params[k] for k in names]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [p.detach() for p in params],
                                    alpha=1.0 - d)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        return state, metrics

    @torch.no_grad()
    def eval_step(self, model: WildlifeMapper, batch: Dict[str, torch.Tensor]):
        """(outputs, losses) of the deterministic forward; batch_valid
        (B,) marks the real rows of a padded final batch."""
        out = model(self.images(batch), deterministic=True)
        losses = set_criterion(out, batch, self.cfg.criterion,
                               num_classes=self.cfg.model.num_classes,
                               row_valid=batch.get("batch_valid"),
                               global_batch=self.data_group is not None)
        return out, losses
