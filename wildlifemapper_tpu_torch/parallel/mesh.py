"""The data axis of the device mesh; counterpart of the data half of
wildlifemapper_tpu/parallel/mesh.py.

The reference's only distribution strategy is NCCL data-parallel DDP
(train_utils.py:6-27, train.py:205-207). The JAX package lays it out as the
'data' axis of a ('data', 'model') mesh, whose 'model' axis shards attention
and MLP weights (TP_RULES there). The port runs one process per card and
the data axis is the default process group: every rank holds the whole
model, takes its own rows of the batch, and DistributedDataParallel averages
the gradients inside the backward. A run is data-parallel exactly when that
group is initialised (parallel/distributed.py::init_distributed_mode), and
every module that acts over the data axis (the step and its criterion, the
meters, checkpoints, evaluation, the loop, the mosaic) reads the group. The
model axis (tensor parallelism) is the next slice of the port (ROADMAP.md,
queue 1 item 7, "Tensor parallelism").
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from . import distributed as dist_lib

TP_REFUSAL = ("tensor parallelism (a model axis above 1) is not ported: it "
              "is the next slice of the port, ROADMAP.md queue 1 item 7, "
              "\"Tensor parallelism\"")


def make_mesh(model_parallel: int = 1) -> Optional[dist.ProcessGroup]:
    """The data axis over the world: the default process group, or None in
    a single process. A model axis above 1 is refused."""
    if model_parallel > 1:
        raise NotImplementedError(f"model_parallel={model_parallel}: "
                                  + TP_REFUSAL)
    if not dist_lib.is_dist_avail_and_initialized():
        return None
    return dist.group.WORLD


def data_parallel(model: torch.nn.Module) -> DistributedDataParallel:
    """`model` wrapped for the data axis: its parameters broadcast from rank
    0 at construction, and the gradients of those that require one (apply
    the freeze policy first) averaged over the ranks inside the backward,
    written straight into the buckets (gradient_as_bucket_view).

    Every trainable parameter receives a gradient in every training
    configuration (tests/test_torch_distributed.py), so
    find_unused_parameters stays off. Buffers keep DDP's default, a
    broadcast from rank 0 before each forward: the model's one buffer is the
    prompt encoder's 1 KiB Gaussian matrix, a constant, and newer torch
    deprecates the `broadcast_buffers` keyword."""
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        gradient_as_bucket_view=True)
