"""The device mesh, its data axis and its model axis; counterpart of
wildlifemapper_tpu/parallel/mesh.py.

The reference's only distribution strategy is NCCL data-parallel DDP
(train_utils.py:6-27, train.py:205-207). The JAX package lays the devices
out as a ('data', 'model') mesh; the port runs one process per card and
lays the ranks out the same way, a grid of world / P data ranks x P model
ranks (`make_mesh(P)`):

  * the data axis: the ranks that share a model index form a data group.
    Each takes its own rows of the batch, and DistributedDataParallel over
    the data group averages the gradients inside the backward. Every module
    that acts over the data axis (the step and its criterion, the meters,
    checkpoints, evaluation, the loop) reads the data group
    (parallel/distributed.py). With P = 1 the data group is the world: a
    run is data-parallel exactly when the default process group is
    initialised.
  * the model axis (tensor parallelism, P > 1): P consecutive ranks form a
    model group and hold one model between them. TP_RULES name the split
    layers: attention's qkv / proj, the MLPs' lin1 / lin2, the adaptor's
    in_proj / out_proj and linear1 / linear2, the decoder's q / k / v_proj
    / out_proj. Each pair is a column split and a row split
    (parallel/tensor_parallel.py): the ViT-H case the JAX package's model
    axis exists for, whose parameters, gradients and Adam moments then take
    about half the memory of a rank.

`_divisible` differs from the JAX package's, which checks each dimension
(3C % P for qkv): the port splits a pair only by whole heads (or, for an
MLP, a hidden width that P divides), and a pair it cannot split stays whole
on every rank, both its layers. The kernels then run on a rank's heads or
hidden shard; one whose shape a kernel refuses raises there.

Checkpoints keep the one-process format: `gather_params` joins the shards,
`shard_params` cuts a whole state dict (from JAX, a reference .pth or a
checkpoint) into this rank's.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from . import distributed as dist_lib


class Split(NamedTuple):
    """How a tensor is split over the model axis: along `dim`, and within
    each of `parts` equal blocks of that dim (qkv and in_proj pack q, k and
    v: a rank holds its heads of each)."""

    dim: int
    parts: int = 1


# (regex over a state-dict name, Split) — first match wins. Torch weights are
# (out, in), flax kernels (in, out) (weights.py): the JAX package's
# P(None, "model") on a kernel is dim 0 here, P("model", None) dim 1.
TP_RULES = (
    (r".*attn\.qkv\.(weight|bias)$", Split(0, 3)),
    (r".*attn\.proj\.weight$", Split(1)),
    (r".*mlp\.lin1\.(weight|bias)$", Split(0)),
    (r".*mlp\.lin2\.weight$", Split(1)),
    (r".*cross_attn\.in_proj_(weight|bias)$", Split(0, 3)),   # q/k/v_proj
    (r".*(linear1|q_proj|k_proj|v_proj)\.(weight|bias)$", Split(0)),
    (r".*(linear2|out_proj)\.weight$", Split(1)),
)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of data ranks x model ranks over the world: this rank's data
    group (the ranks with its model index) and model group (P consecutive
    ranks), with its place in each."""

    world: dist.ProcessGroup
    data: dist.ProcessGroup
    model: dist.ProcessGroup
    data_size: int
    model_size: int
    data_rank: int
    model_rank: int


def make_mesh(model_parallel: int = 1):
    """P = 1: the data axis over the world, the default process group or
    None in a single process. P > 1: the grid of world / P data ranks x P
    model ranks (made once for a world, with dist.new_group on every rank in
    the same order), which the data- and model-group helpers of
    parallel/distributed.py read from then on."""
    if model_parallel == 1:
        dist_lib.set_grid(None)
        if not dist_lib.is_dist_avail_and_initialized():
            return None
        return dist.group.WORLD
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    grouped = dist_lib.is_dist_avail_and_initialized()
    world = dist_lib.get_world_size()
    if not grouped or world % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} splits the model over "
            f"{model_parallel} ranks: run a multiple of {model_parallel} "
            f"processes (torchrun --nproc_per_node {model_parallel} ...); "
            f"this one has "
            + (f"a world of {world}" if grouped else "no process group"))
    grid = dist_lib.current_grid()
    if grid is not None and grid.model_size == model_parallel:
        return grid
    rank = dist_lib.get_rank()
    model = data = None
    for i in range(world // model_parallel):
        ranks = list(range(i * model_parallel, (i + 1) * model_parallel))
        group = dist.new_group(ranks)
        if rank in ranks:
            model = group
    for j in range(model_parallel):
        ranks = list(range(j, world, model_parallel))
        group = dist.new_group(ranks)
        if rank in ranks:
            data = group
    grid = Mesh(world=dist.group.WORLD, data=data, model=model,
                data_size=world // model_parallel, model_size=model_parallel,
                data_rank=rank // model_parallel,
                model_rank=rank % model_parallel)
    dist_lib.set_grid(grid)
    return grid


def data_axis(mesh) -> Optional[dist.ProcessGroup]:
    """The group a step over `mesh` (make_mesh's result) is data-parallel
    over: the world (P = 1 in a process group), the data group when it has
    more than one rank, else None."""
    if isinstance(mesh, Mesh):
        return mesh.data if mesh.data_size > 1 else None
    return mesh


def data_parallel(model: torch.nn.Module,
                  group: Optional[dist.ProcessGroup] = None
                  ) -> DistributedDataParallel:
    """`model` wrapped for the data axis (`group`; the world for None): its
    parameters broadcast from the group's first rank at construction, and
    the gradients of those that require one (apply the freeze policy first)
    averaged over the group inside the backward, written straight into the
    buckets (gradient_as_bucket_view).

    Every trainable parameter receives a gradient in every training
    configuration (tests/test_torch_distributed.py), so
    find_unused_parameters stays off. Buffers keep DDP's default, a
    broadcast from the first rank before each forward: the model's one
    buffer is the prompt encoder's 1 KiB Gaussian matrix, a constant, and
    newer torch deprecates the `broadcast_buffers` keyword."""
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        gradient_as_bucket_view=True, process_group=group)


# ---- the model axis ---------------------------------------------------------

def _owner(model: nn.Module, name: str) -> nn.Module:
    """The module whose split pair holds parameter `name`: the nearest
    enclosing module with a tp_width."""
    parts = name.split(".")[:-1]
    while parts:
        mod = model.get_submodule(".".join(parts))
        if hasattr(mod, "tp_width"):
            return mod
        parts.pop()
    raise ValueError(f"{name} matches a TP rule but no split pair holds it")


def _divisible(model: nn.Module, name: str, model_parallel: int) -> bool:
    """Whether the pair of `name` splits over `model_parallel` ranks: its
    heads (attention) or its hidden width (an MLP) divide by it."""
    return _owner(model, name).tp_width() % model_parallel == 0


def param_pspec(model: nn.Module, model_parallel: int
                ) -> Dict[str, Optional[Split]]:
    """The Split of every state-dict entry of the whole `model` over
    `model_parallel` ranks: the first TP rule that its name matches, None
    (whole on every rank) for the rest, and for both layers of a pair that
    `_divisible` refuses."""
    out = {}
    for name in model.state_dict():
        spec = None
        if model_parallel > 1:
            for pat, s in TP_RULES:
                if re.match(pat, name):
                    if _divisible(model, name, model_parallel):
                        spec = s
                    break
        out[name] = spec
    return out


def _shard(t: torch.Tensor, spec: Split, rank: int, ranks: int):
    blocks = t.chunk(spec.parts, spec.dim)
    return torch.cat([b.chunk(ranks, spec.dim)[rank] for b in blocks],
                     spec.dim).contiguous()


def shard_params(state_dict: Mapping[str, torch.Tensor],
                 specs: Mapping[str, Optional[Split]], rank: int,
                 ranks: int) -> Dict[str, torch.Tensor]:
    """Model rank `rank`'s shard of a whole state dict (names as
    param_pspec's; anything without a Split as it is)."""
    return {k: (_shard(v, specs[k], rank, ranks) if specs.get(k) else v)
            for k, v in state_dict.items()}


def gather_params(shards: List[Mapping[str, torch.Tensor]],
                  specs: Mapping[str, Optional[Split]]
                  ) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model rank's shard (in rank order):
    the inverse of shard_params."""
    out = {}
    for k, v in shards[0].items():
        spec = specs.get(k)
        if not spec:
            out[k] = v
            continue
        blocks = [s[k].chunk(spec.parts, spec.dim) for s in shards]
        out[k] = torch.cat([torch.cat([b[p] for b in blocks], spec.dim)
                            for p in range(spec.parts)], spec.dim)
    return out


def _map_moments(opt_state: Mapping, names: List[str],
                 specs: Mapping[str, Optional[Split]], fn) -> dict:
    """opt_state with fn(tensor, Split) in place of each moment (a tensor
    of the parameter's shape) of a split parameter; `names[i]` is the
    parameter of index i."""
    out = {"state": {}, "param_groups": opt_state["param_groups"]}
    for i, entry in opt_state["state"].items():
        spec = specs.get(names[i])
        out["state"][i] = {
            k: (fn(v, spec) if spec and isinstance(v, torch.Tensor)
                and v.dim() > 0 else v) for k, v in entry.items()}
    return out


def shard_opt_state(opt_state: Mapping, names: List[str],
                    specs: Mapping[str, Optional[Split]], rank: int,
                    ranks: int) -> dict:
    """A whole model's optimizer state_dict with the moments of each split
    parameter cut to model rank `rank`'s shard: they follow their
    parameters, so a rank holds its own parameters' moments only.
    `names[i]` is the parameter of index i; counts and hyper-parameters
    stay as they are."""
    return _map_moments(opt_state, names, specs,
                        lambda v, spec: _shard(v, spec, rank, ranks))


@dataclasses.dataclass
class ModelShards:
    """A model split over `mesh`'s model axis by `specs` (shard_model):
    what checkpoints read to gather and cut its state."""

    mesh: Mesh
    specs: Dict[str, Optional[Split]]

    def shard(self, state_dict: Mapping[str, torch.Tensor]):
        """This rank's shard of a whole state dict."""
        return shard_params(state_dict, self.specs, self.mesh.model_rank,
                            self.mesh.model_size)

    def _gather(self, t: torch.Tensor, spec: Split) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.mesh.model_size)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.model)
        return gather_params([{"t": p} for p in parts], {"t": spec})["t"]

    def gather(self, state_dict: Mapping[str, torch.Tensor]):
        """The whole state dict, on every rank of the model group, from
        each rank's shard (collectives over the group, in the dict's
        order)."""
        return {k: (self._gather(v, self.specs[k]) if self.specs.get(k)
                    else v) for k, v in state_dict.items()}

    def gather_opt_state(self, opt_state: Mapping, names: List[str]):
        """The whole model's optimizer state_dict from each rank's."""
        return _map_moments(opt_state, names, self.specs, self._gather)

    def shard_opt_state(self, opt_state: Mapping, names: List[str]):
        """This rank's optimizer state_dict from the whole model's."""
        return shard_opt_state(opt_state, names, self.specs,
                               self.mesh.model_rank, self.mesh.model_size)


def shard_model(model: nn.Module, mesh: Mesh) -> ModelShards:
    """Split the whole `model` in place over `mesh`'s model axis: every
    parameter that param_pspec splits becomes this rank's shard (the same
    Parameter object is not kept: build the optimizer after this), marked
    with its Split as `model_parallel_split`, and each split pair's modules
    learn their part (their `tp_split`). Load whole weights into the model
    first; the model's random initialisation, drawn whole, is the same on
    every rank."""
    specs = param_pspec(model, mesh.model_size)
    local = shard_params(model.state_dict(), specs, mesh.model_rank,
                         mesh.model_size)
    owners = {}
    for name, spec in specs.items():
        if not spec:
            continue
        owner = _owner(model, name)
        owners[id(owner)] = owner
        mod_name, attr = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        old = getattr(mod, attr)
        new = nn.Parameter(local[name], requires_grad=old.requires_grad)
        new.model_parallel_split = spec
        setattr(mod, attr, new)
        if isinstance(mod, nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape
    for owner in owners.values():
        owner.tp_split(mesh.model, mesh.model_size, mesh.model_rank)
    return ModelShards(mesh, specs)
