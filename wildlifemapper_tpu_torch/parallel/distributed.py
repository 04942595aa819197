"""Process-group initialisation and cross-process helpers; counterpart of
wildlifemapper_tpu/parallel/distributed.py, under the same names.

Behavioral parity target: train_utils.py:6-69 + misc.py:118-220 of the
reference: env-driven process-group init (torchrun's RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), rank helpers, rank-0-only printing,
object all_gather. One process per card; NCCL between cards, gloo on the CPU
or where the caller asks for it.
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


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order, on every rank (misc.py:180-220):
    torch's pickling all_gather_object, which pads the ragged payloads
    itself. `[obj]` with one process."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, out of place and outside autograd.
    On the card it is queued on the stream like a kernel, with no wait for
    the host."""
    total = t.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total


class _SumOfShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, share: torch.Tensor, world_size: int):
        ctx.world_size = world_size
        return all_reduce_sum(share)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad * ctx.world_size, None


def sum_of_shares(share: torch.Tensor) -> torch.Tensor:
    """The global value of a loss that each rank holds a share of (its own
    rows over the global batch's normaliser): the sum over the ranks,
    identical on every rank. Its backward hands each rank world_size times
    the gradient of its share, so that DistributedDataParallel's mean of
    the ranks' gradients is the gradient of the global sum."""
    return _SumOfShares.apply(share, get_world_size())
