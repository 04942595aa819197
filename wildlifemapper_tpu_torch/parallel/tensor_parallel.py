"""The two collectives of a Megatron-style split over the model axis; the
port's counterpart of what XLA inserts for the 'model' axis of
wildlifemapper_tpu/parallel/mesh.py::TP_RULES.

A split pair is a column-split layer (its output features, whole heads or a
slice of the hidden width, are this rank's) followed by a row-split layer
(its input features are this rank's, so each rank holds a partial sum of
its output). Between the two every rank computes on its own shard and
nothing crosses ranks:

  * `copy_to_model` goes on the input of the column split: the identity
    forward, and in the backward the sum over the model group of the
    ranks' input gradients, each of which covers only its own shard. A
    replicated parameter that is read inside the pair (the rel-pos tables)
    goes through it as well, so that its gradient is the whole one.
  * `reduce_from_model` goes on the output of the row split: the sum of
    the partial products over the model group in the forward, and the
    identity backward.

The sums run in the tensors' own dtype: bf16 partial products and
gradients cross the group as bf16 (half the bytes of float32), and a row
split adds its float32 bias to the sum before rounding it again
(models/common.py::Linear.finish).

Both are no-ops without a model group. `all_reduce_model.count` counts the
collectives they issue (and the clip's, train/optimizer.py): a step counts
the same with remat_blocks on and off, since no collective runs in a
recompute.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_reduce_model(t: torch.Tensor,
                     group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of `t` over `group`, out of place, counted."""
    total = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    all_reduce_model.count += 1
    return total


# collectives over the model group issued so far in this process
all_reduce_model.count = 0


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_model(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_model(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor,
                  group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """`x` as it is; its gradient summed over the model group."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor,
                      group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum over the model group of the ranks' partial `x`; its gradient
    handed to each rank as it is."""
    if group is None:
        return x
    return _ReduceFromModel.apply(x, group)
