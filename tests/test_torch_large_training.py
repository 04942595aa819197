"""The large encoders' training paths of the port: the configuration that
train/synthetic.py builds for ViT-L and ViT-H from scratch against the one
the JAX package's training CLI builds from the same flags, and what the
remat recompute runs.

What is compared, and how tightly:
  * `training_config("from_scratch", variant)` against the JAX
    `cli/train.py::config_from_args` with the flags a user passes for that
    run, field for field (flattened dataclasses, exact), for vit_l and
    vit_h with remat on and off. Two fields differ by design and are named:
    the port's `DataConfig.coco_path` defaults to its vendored bundle, and
    `training_config` sets hfc.dropout 0 so that the adaptor's attention
    runs its kernel (K4) and its backward in training; the CLI (either
    package) keeps the reference's 0.1. The port's own CLI gives the JAX
    CLI's config but for the bundle's path.
  * The recompute of a remat block's attention segment runs norm1, qkv and
    the attention again and not proj's GEMM, with torch's checkpoint
    stopping its recompute early (once it has every tensor the backward
    saved) and without: within the recompute proj keeps its input and the
    weight and runs no product (`outputs_unread`). Read from the operators
    the backward dispatches (exact counts); the gradients equal those
    without remat at rtol 1e-6.
"""

import argparse
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from wildlifemapper_tpu.cli import train as jcli
from wildlifemapper_tpu_torch.cli import train as tcli
from wildlifemapper_tpu_torch.models.vit import Block
from wildlifemapper_tpu_torch.train.synthetic import training_config


def _flat(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def _flags(variant, remat):
    """The command line of a ViT-L / ViT-H from-scratch run at batch 4
    (`scripts/train_herdnet_torch.sh`'s architecture flags)."""
    return (["--model_type", variant, "--train_encoder", "--content_size",
             "768", "--crop_prologue", "--window_size", "12", "--use_amp",
             "--batch_size", "4", "--device_normalize", "--max_targets",
             "128"] + (["--remat"] if remat else []))


def _from_args(cli, argv):
    return cli.config_from_args(
        cli.add_config_args(argparse.ArgumentParser()).parse_args(argv))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("variant", ["vit_l", "vit_h"])
def test_from_scratch_config_matches_the_jax_cli(variant, remat):
    want = _flat(_from_args(jcli, _flags(variant, remat)))
    got = _flat(training_config("from_scratch", variant=variant,
                                remat_blocks=remat))
    port_cli = _flat(_from_args(tcli, _flags(variant, remat)))
    assert set(got) == set(want) == set(port_cli)
    differ = {k for k in want if got[k] != want[k]}
    assert differ == {"data.coco_path", "model.hfc.dropout"}
    assert (got["model.hfc.dropout"], want["model.hfc.dropout"]) == (0.0, 0.1)
    assert {k for k in want if port_cli[k] != want[k]} == {"data.coco_path"}
    assert got["data.coco_path"] == port_cli["data.coco_path"]
    # the run's own fields: the published width and the from-scratch shape
    assert (got["model.vit.embed_dim"], got["model.vit.num_heads"]) == {
        "vit_l": (1024, 16), "vit_h": (1280, 16)}[variant]
    assert got["model.vit.window_size"] == 12
    assert got["model.content_size"] == 768 and got["model.crop_prologue"]
    assert got["model.remat_blocks"] == remat
    assert not got["train.freeze_encoder"] and got["train.use_amp"]


class _Log(TorchDispatchMode):
    """The matrix products dispatched while it is on, with their operands'
    shapes."""

    def __init__(self):
        super().__init__()
        self.products = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.addmm.default, torch.ops.aten.mm.default):
            self.products.append(
                (func.__name__.split(".")[0],
                 tuple(tuple(a.shape) for a in args if torch.is_tensor(a))))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("window,trainable", [(0, True), (4, True),
                                              (4, False)])
def test_remat_recompute_runs_no_proj_gemm(window, trainable, early_stop):
    """A remat block's backward recomputes qkv's product and not proj's,
    whatever the encoder's freezing, and also where torch's checkpoint does
    not stop its recompute early (proj's product is left out by
    `outputs_unread` around the attention segment's recompute): with remat
    the backward dispatches exactly the products it dispatches without
    remat plus the recompute of qkv and of the (plain) MLP's first product,
    and, without the early stop, of its second, whose output the plain MLP's
    backward does not read either."""
    dim, rows = 32, 2 * 8 * 8
    proj = ("addmm", ((dim,), (rows, dim), (dim, dim)))
    qkv = ("addmm", ((3 * dim,), (rows, dim), (dim, 3 * dim)))
    lin1 = ("addmm", ((4 * dim,), (rows, dim), (dim, 4 * dim)))
    lin2 = ("addmm", ((dim,), (rows, 4 * dim), (4 * dim, dim)))
    logs, grads = {}, {}
    for remat in (False, True):
        torch.manual_seed(0)
        blk = Block(dim, 2, window_size=window, table_size=(8, 8),
                    remat=remat)
        blk.requires_grad_(trainable)
        x = torch.randn(2, 8, 8, dim, requires_grad=True)
        # read when the checkpoint is made, in the forward
        with set_checkpoint_early_stop(early_stop):
            with _Log() as fwd:
                y = blk(x)
            with _Log() as bwd:
                y.sum().backward()
        logs[remat] = (fwd.products, bwd.products)
        grads[remat] = [x.grad] + [p.grad for p in blk.parameters()]
    assert logs[False][0] == logs[True][0]
    assert logs[True][0].count(proj) == 1 and logs[True][0].count(qkv) == 1
    recomputed = list(logs[True][1])
    for p in logs[False][1]:
        recomputed.remove(p)
    assert sorted(recomputed) == sorted([qkv, lin1] + (
        [] if early_stop else [lin2]))
    assert proj not in logs[True][1]
    for a, b in zip(grads[False], grads[True]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
