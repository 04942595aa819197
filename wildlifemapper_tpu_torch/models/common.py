"""Shared layers (counterpart of wildlifemapper_tpu/models/common.py;
reference segment_anything/modeling/common.py, box_decoder.py:154-176).

Parameters stay float32; every layer computes in the dtype of its input and
casts its parameters to it, as flax `Dense(dtype=...)` does.

Under tensor parallelism (parallel/mesh.py::shard_model) a Linear or an
MLPBlock may hold one rank's shard: see Linear.split. `partial` then gives
this rank's share of the output and `finish` turns the shares into the
output on every rank; without a split `partial` is the forward and `finish`
the identity.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_mlp import fused_mlp, outputs_unread_active
from ..parallel.tensor_parallel import copy_to_model, reduce_from_model


class Linear(nn.Linear):
    """nn.Linear that casts its float32 parameters to the input's dtype.

    `split` is the layer's part in a tensor-parallel pair (set by
    parallel/mesh.py::shard_model, with `group` the model group): None, the
    whole layer; "column", this rank's rows of the weight and the bias (its
    output features), its input's gradient summed over the group; "row",
    this rank's columns of the weight (its input features): `partial` gives
    the product without the bias, and `finish` sums the ranks' products and
    adds the whole bias once, on every rank, so that each rank's bias takes
    the whole gradient."""

    split = None
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split is not None:
            return self.finish(self.partial(x))
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of the output (the output itself unless the
        layer is a row split)."""
        if self.split is None:
            return self.forward(x)
        if self.split == "column":
            x = copy_to_model(x, self.group)
        b = (None if self.bias is None or self.split == "row"
             else self.bias.to(x.dtype))
        return F.linear(x, self.weight.to(x.dtype), b)

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        """The output from the ranks' `partial`s: their sum and the bias
        for a row split, `y` itself otherwise."""
        if self.split != "row":
            return y
        total = reduce_from_model(y, self.group)
        if self.bias is None:
            return total
        return (total.float() + self.bias.float()).to(y.dtype)

    def forward_in_remat(self, x: torch.Tensor) -> torch.Tensor:
        """`partial` of a whole layer or a row split that ends a remat
        segment, whose output the recompute does not read: see
        _RematLinearFn."""
        b = (None if self.bias is None or self.split == "row"
             else self.bias.to(x.dtype))
        return _RematLinearFn.apply(x, self.weight.to(x.dtype), b)


class _RematLinearFn(torch.autograd.Function):
    """F.linear that keeps x and the weight for its backward and, within
    ops.fused_mlp.outputs_unread() (the recompute of a remat segment, which
    runs only for the tensors the backward saves), runs no product and
    returns a zero that holds no memory (one element, stride 0): the JAX
    package's remat leaves out a product whose result its backward does not
    read. The backward is addmm's (AddmmBackward0, through which F.linear
    differentiates) on the same operands: dx = g W, dW = g^T x, db = g
    summed to the bias's shape."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        if outputs_unread_active():
            return x.new_zeros(()).expand(*x.shape[:-1], weight.shape[0])
        return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = g.mm(weight).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = g.t().mm(x.reshape(-1, x.shape[-1]))
        if ctx.needs_input_grad[2]:
            db = g.sum_to_size(weight.shape[:1])
        return dx, dw, db


class LayerNorm(nn.LayerNorm):
    """LayerNorm with the JAX package's eps (1e-6, flax's default), its
    statistics in float32 and its output in the input's dtype. Also serves
    as SAM's channel-last LayerNorm2d (`ChannelLayerNorm`)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


ChannelLayerNorm = LayerNorm


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv2d applied to the channel axis of an NHWC tensor."""
    w = conv.weight[:, :, 0, 0].to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.linear(x, w, b)


class MLPBlock(nn.Module):
    """lin1 -> act -> lin2 (reference common.py:13-28).

    With use_fused (and the default exact-erf GELU) it runs the fused MLP
    kernel (ops/fused_mlp.py, K3); the parameters are the same either way.
    Split over the model axis (lin1 a column split, lin2 a row split) the
    kernel runs on this rank's hidden shard with a zero fc2 bias, and
    lin2's bias is added once after the sum over the ranks (`finish`).
    """

    def __init__(self, dim: int, mlp_dim: int, act: str = "gelu",
                 use_fused: bool = False):
        super().__init__()
        if act not in ("gelu", "relu"):
            raise ValueError(f"unknown activation {act!r}")
        self.lin1 = Linear(dim, mlp_dim)
        self.lin2 = Linear(mlp_dim, dim)
        self.act = act
        self.use_fused = use_fused

    def tp_width(self) -> int:
        """What a model axis must divide to split the MLP: its hidden
        width."""
        return self.lin1.out_features

    def tp_split(self, group, ranks: int, rank: int) -> None:
        """Run as this rank's shard of lin1 / lin2 (parallel/mesh.py)."""
        self.lin1.split, self.lin1.group = "column", group
        self.lin2.split, self.lin2.group = "row", group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.finish(self.partial(x))

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP's output, or with a split this rank's share of it."""
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        if self.use_fused and self.act == "gelu":
            dt = x.dtype
            b2 = self.lin2.bias.float()
            if self.lin2.split == "row":
                x = copy_to_model(x, self.lin1.group)
                b2 = torch.zeros_like(b2)
            x = fused_mlp(x, self.lin1.weight.to(dt), self.lin1.bias.float(),
                          self.lin2.weight.to(dt), b2)
        else:
            h = self.lin1.partial(x)
            h = F.gelu(h) if self.act == "gelu" else F.relu(h)
            x = self.lin2.partial(h)
        return x.reshape(*shape[:-1], x.shape[-1])

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        return self.lin2.finish(y)


class MLPHead(nn.Module):
    """(num_layers-1) x [Linear + ReLU] + Linear (box_decoder.py:154-176)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, sigmoid_output: bool = False):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1]) for i in range(num_layers))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: torch.Generator | None,
            shard: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Inverted dropout driven by an explicit generator (flax nn.Dropout).

    `shard` (dim, ranks, rank): `x` is this rank's slice of dim `dim` of a
    tensor `ranks` times as wide there; the mask of the whole tensor is
    drawn, as one process draws it, and this rank's slice kept."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    shape = list(x.shape)
    if shard is not None:
        dim, ranks, rank = shard
        shape[dim] *= ranks
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if shard is not None:
        keep = keep.narrow(dim, rank * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
