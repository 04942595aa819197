"""Process-group initialisation and cross-process helpers; counterpart of
wildlifemapper_tpu/parallel/distributed.py, under the same names.

Behavioral parity target: train_utils.py:6-69 + misc.py:118-220 of the
reference: env-driven process-group init (torchrun's RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), rank helpers, rank-0-only printing,
object all_gather. One process per card; NCCL between cards, gloo on the CPU
or where the caller asks for it.

The world is a grid of data ranks x model ranks (parallel/mesh.py). A data
group holds the ranks that share a model index: they take different rows of
each batch, so the code that acts over the data axis (the criterion's
normalisers, the meters, the evaluation merge, the loaders' shards, the
dropout seeds) reads the data group's rank and size, never the world's. A
model group holds the ranks of one tensor-parallel model, whose split
parameters are spread over them (parallel/tensor_parallel.py). Without a
model axis the data group is the world.
"""

from __future__ import annotations

import builtins
import functools
import os
from typing import Any, List, Optional, Union

import torch
import torch.distributed as dist


def init_distributed_mode(init_method: Optional[str] = None,
                          world_size: Optional[int] = None,
                          rank: Optional[int] = None,
                          local_rank: Optional[int] = None,
                          backend: Optional[str] = None,
                          device: Union[None, str, torch.device] = None
                          ) -> bool:
    """Join the process group. No-op (returns False) for a single process:
    no explicit `world_size` and no torchrun environment, mirroring the
    reference's fallback (train_utils.py:14-19). Under torchrun the rank,
    world size and local rank come from its environment and the group from
    MASTER_ADDR / MASTER_PORT; explicit arguments take their place (a test
    passes `init_method="tcp://127.0.0.1:<port>"`).

    `device` is where the rank runs, as the port's entry points take it:
    None is the card, `cuda:<local_rank>`, which becomes the current device
    before anything touches the card (the kernels launch on the current
    device, and NCCL's object collectives stage through it); "cpu" runs on
    the CPU. `backend` defaults to "nccl" on the card and "gloo" on the
    CPU; two ranks that share one card pass backend="gloo" and
    local_rank=0, since NCCL refuses two ranks on one device."""
    if world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(local_rank)
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank)
    return True


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


# the grid that parallel/mesh.py::make_mesh laid over the world (a grid made
# in a group since destroyed is no longer this process's)
_grid = None


def set_grid(grid) -> None:
    """Record `grid` (a parallel.mesh.Mesh, or None for no model axis) as
    the one that the data- and model-group helpers read."""
    global _grid
    _grid = grid


def current_grid():
    """The grid set_grid recorded, while the process group it was made in
    lives; None otherwise."""
    if (_grid is None or not is_dist_avail_and_initialized()
            or _grid.world is not dist.group.WORLD):
        return None
    return _grid


def data_group() -> Optional[dist.ProcessGroup]:
    """The ranks that share this rank's model index: the mesh's data group,
    the world without a model axis, None in one process."""
    grid = current_grid()
    if grid is not None:
        return grid.data
    return dist.group.WORLD if is_dist_avail_and_initialized() else None


def model_group() -> Optional[dist.ProcessGroup]:
    """The ranks of this rank's tensor-parallel model; None without a model
    axis."""
    grid = current_grid()
    return None if grid is None else grid.model


def get_data_rank() -> int:
    """This rank's index in its data group (0 in one process)."""
    grid = current_grid()
    return get_rank() if grid is None else grid.data_rank


def get_data_world_size() -> int:
    """The number of ranks of the data group (1 in one process)."""
    grid = current_grid()
    return get_world_size() if grid is None else grid.data_size


def get_model_rank() -> int:
    """This rank's index in its model group (0 without a model axis)."""
    grid = current_grid()
    return 0 if grid is None else grid.model_rank


def get_model_world_size() -> int:
    """The number of ranks of the model group (1 without a model axis)."""
    grid = current_grid()
    return 1 if grid is None else grid.model_size


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def save_on_master(fn, *args, **kwargs):
    if is_main_process():
        return fn(*args, **kwargs)
    return None


def barrier() -> None:
    """Wait for every rank; nothing to wait for with one process."""
    if get_world_size() > 1:
        dist.barrier()


def setup_for_distributed(is_master: bool):
    """Patch print to main-process only (train_utils.py:30-42);
    print(..., force=True) prints on every rank."""
    orig_print = builtins.print

    @functools.wraps(orig_print)
    def print_(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            orig_print(*args, **kwargs)

    builtins.print = print_


def group_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """The number of ranks of `group` (the world for None; 1 in one
    process)."""
    if not is_dist_avail_and_initialized():
        return 1
    return dist.get_world_size(group)


def all_gather_objects(obj: Any, group: Optional[dist.ProcessGroup] = None
                       ) -> List[Any]:
    """Every rank's `obj`, in rank order, on every rank of `group` (the
    world for None; misc.py:180-220): torch's pickling all_gather_object,
    which pads the ragged payloads itself. `[obj]` with one rank."""
    n = group_size(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def all_reduce_sum(t: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (the data group for None),
    out of place and outside autograd. On the card it is queued on the
    stream like a kernel, with no wait for the host."""
    total = t.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM,
                    group=data_group() if group is None else group)
    return total


class _SumOfShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, share: torch.Tensor, group):
        ctx.size = group_size(group)
        return all_reduce_sum(share, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad * ctx.size, None


def sum_of_shares(share: torch.Tensor) -> torch.Tensor:
    """The global value of a loss that each data rank holds a share of (its
    own rows over the global batch's normaliser): the sum over the data
    group, identical on each of its ranks. Its backward hands each rank the
    data group's size times the gradient of its share, so that
    DistributedDataParallel's mean over the data group is the gradient of
    the global sum."""
    return _SumOfShares.apply(share, data_group())
