"""The exportable forward of the port (wildlifemapper_tpu_torch/compat/
export.py, cli/export.py) and the `wm::` operators it captures on the card
(ops/_library.py), on the CPU:

  * the tiny model (tests/test_model.py:14's config, perturbed JAX weights
    carried across) exported with a symbolic batch and saved: the loaded
    program bit for bit the eager port at batch 1 and 3, also in a fresh
    process that imports `wildlifemapper_tpu_torch.ops` and not the models;
    within atol 1e-4 / rtol 1e-3 of the JAX package's exported call,
    `load_exported(...)(params, x)` (its symbolic-batch export of the plain
    path at batch 1 and 3, and its export with the Pallas kernels at a
    fixed batch of 3: the Pallas calls refuse a symbolic batch);
  * every `wm::` operator (both overloads of the five attention operators,
    and K3's) under `torch.library.opcheck` through its CPU implementation
    in float32 and bfloat16, and equal to the wrapper's plain version;
  * a module that calls the operators directly exports with a symbolic
    batch; the model, with its wrappers routed into their autograd
    functions as a CUDA tensor routes them, exports with one `wm::` node a
    kernel launch (packed: K1, K2, K3 a block, K4; grouped: K6, K5, K4) and
    no library attention, and its program counts the launches when it runs
    (the operators' CUDA implementations against a stand-in library), not
    when it is traced;
  * the CLI end to end, with a trainer's checkpoint and a reference .pth.
"""

import collections
import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.export import Dim
from torch.library import opcheck

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.compat import export as jexport
from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.cli import export as cli_export
from wildlifemapper_tpu_torch.cli import train as cli_train
from wildlifemapper_tpu_torch.compat import export as texport
from wildlifemapper_tpu_torch.models import WildlifeMapper, adaptor, common
from wildlifemapper_tpu_torch.models import vit as tvit
from wildlifemapper_tpu_torch.ops import _attention, _build, _library
from wildlifemapper_tpu_torch.ops import cross_attention as ca
from wildlifemapper_tpu_torch.ops import flash_attention as fa
from wildlifemapper_tpu_torch.ops import flash_attention_v2 as f2
from wildlifemapper_tpu_torch.ops import fused_mlp as fm
from wildlifemapper_tpu_torch.ops import windowed_attention as wa
from wildlifemapper_tpu_torch.ops import windowed_attention_v2 as w2
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.test_torch_attention_bodies import (_StandInLibrary,
                                               cuda_impls_on_cpu)
from tests.torch_common import (flat_numpy, perturbed, tiny_config,
                                to_numpy, to_torch)

TOL = dict(atol=1e-4, rtol=1e-3)
KEYS = ("pred_logits", "pred_boxes")


def _config(mod, **overrides):
    """tests/test_model.py:14's tiny config (img 64), the kernels on."""
    overrides.setdefault("use_flash_attention", True)
    return dataclasses.replace(tiny_config(mod, **overrides), img_size=64)


def _inputs(batch, seed=0, img=64):
    return np.random.default_rng(seed).normal(
        size=(batch, img, img, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """JAX weights, the port's model with them, its saved program."""
    jc, tc = _config(jcfg), _config(tcfg)
    jm = JaxWildlifeMapper(jc)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        _inputs(1)),
                       np.random.default_rng(0), scale=0.1)
    tm = WildlifeMapper(tc, device="cpu")
    load_reference_state_dict(tm, state_dict_from_jax(flat_numpy(params),
                                                      depth=2))
    path = texport.save_exported(
        tm.eval(), tmp_path_factory.mktemp("export") / "model.pt2",
        batch_size=None)
    return jm, params, tm, path


def test_dynamic_program_is_the_eager_port(exported):
    _, _, tm, path = exported
    program = texport.load_exported(path)
    for batch in (1, 3):
        x = to_torch(_inputs(batch, seed=batch))
        with torch.no_grad():
            got, want = program(x), tm(x)
        for k in KEYS:
            assert got[k].shape == (batch, 7, 8 if k == KEYS[0] else 4)
            assert torch.equal(got[k], want[k]), (batch, k)


def test_program_loads_in_a_process_without_the_models(exported, tmp_path):
    _, _, tm, path = exported
    x = to_torch(_inputs(3, seed=7))
    torch.save(x, tmp_path / "x.pt")
    code = (
        "import sys, torch\n"
        "import wildlifemapper_tpu_torch.ops\n"
        f"program = torch.export.load({str(path)!r}).module()\n"
        f"out = program(torch.load({str(tmp_path / 'x.pt')!r}))\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n"
        "assert 'wildlifemapper_tpu_torch.models' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = torch.load(tmp_path / "out.pt")
    with torch.no_grad():
        want = tm(x)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def jax_exported(exported, tmp_path_factory):
    """The JAX package's exported calls: the plain path with a symbolic
    batch, the Pallas kernels at batch 3."""
    _, params, _, _ = exported
    out = {}
    tmp = tmp_path_factory.mktemp("jax_export")
    for name, flash, batch in (("symbolic", False, None),
                               ("kernels_b3", True, 3)):
        jm = JaxWildlifeMapper(_config(jcfg, use_flash_attention=flash))
        path = jexport.save_exported(jm, params, str(tmp / name), batch,
                                     img_size=64)
        out[name] = jexport.load_exported(str(path))
    return out


@pytest.mark.parametrize("which,batch", [("symbolic", 1), ("symbolic", 3),
                                         ("kernels_b3", 3)])
def test_program_matches_jax_export(exported, jax_exported, which, batch):
    _, params, _, path = exported
    x = _inputs(batch, seed=10 + batch)
    want = jax_exported[which](params, x)
    with torch.no_grad():
        got = texport.load_exported(path)(to_torch(x))
        fixed = texport.export_forward(exported[2], batch_size=batch)
        got_fixed = fixed.module()(to_torch(x))
    for k in KEYS:
        np.testing.assert_allclose(to_numpy(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)
        assert torch.equal(got_fixed[k], got[k]), k


# ---- the operators ------------------------------------------------------------

def _op_args(name, dtype, batch=2, seed=0):
    """Inputs of each operator at a small shape: 2 heads of 32 on a 4x4
    grid, K4 with 24 keys, K3 64 -> 128."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, dt=dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dt)

    n, heads, d = 16, 2, 32
    c = heads * d
    if name in _library.PACKED:
        return (r(batch, n, 3 * c), r(batch, n, heads, 4, scale=0.5),
                r(batch, n, heads, 4, scale=0.5), d ** -0.5, heads)
    if name == "cross_attention_packed":
        return (r(batch, n, c), r(batch, 24, c), r(batch, 24, c), d ** -0.5,
                heads)
    if name in _library.GROUPED:
        bh = batch * heads
        return (r(bh, n, d), r(bh, n, d), r(bh, n, d),
                r(bh, n, 1, 4, scale=0.5), r(bh, n, 1, 4, scale=0.5),
                d ** -0.5)
    return (r(batch * n, c), r(128, c, scale=c ** -0.5),
            r(128, dt=torch.float32, scale=0.1), r(c, 128, scale=128 ** -0.5),
            r(c, dt=torch.float32, scale=0.1))


def _overload(name):
    packet, _, which = name.partition(".")
    return getattr(getattr(torch.ops.wm, packet), which or "default")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(_library.IMPLS))
def test_opcheck(name, dtype):
    args = _op_args(name.partition(".")[0], dtype)
    result = opcheck(_overload(name), args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", _library.OPS)
def test_operator_is_the_plain_version(name):
    """The CPU implementation is the plain version the wrapper runs for a
    CPU tensor; the lse overload's lse is the launcher's layout."""
    args = _op_args(name, torch.float32)
    got = _overload(name)(*args)
    if name == "fused_mlp":
        assert torch.equal(got, fm.fused_mlp_plain(*args))
        return
    q, k, v, scale, heads, rh, rw, scores = _library._operands(
        _library._FAMILY[name], args)
    want, lse = _attention.attention_plain(q, k, v, scale, heads, rh, rw,
                                           return_lse=True,
                                           scale_scores=scores)
    assert torch.equal(got, want)
    out2, lse2 = _overload(name + ".lse")(*args)
    assert torch.equal(out2, want) and torch.equal(lse2, lse)
    assert lse2.is_contiguous() and lse2.shape == (*q.shape[:2], heads)


class _AllOps(torch.nn.Module):
    """Calls each operator on tensors cut from one batch."""

    def forward(self, qkv, rh, rw, x, w1, b1, w2, b2):
        c = qkv.shape[-1] // 3
        out = [torch.ops.wm.windowed_attention_packed(qkv, rh, rw, 0.2, 2),
               torch.ops.wm.flash_attention_packed.lse(qkv, rh, rw, 0.2,
                                                       2)[0],
               torch.ops.wm.cross_attention_packed(
                   qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], 0.2,
                   2)]
        b, n = qkv.shape[:2]
        heads = qkv.reshape(b, n, 3, 2, c // 2).permute(2, 0, 3, 1, 4)
        q, k, v = heads.reshape(3, b * 2, n, c // 2).contiguous()
        gh = rh.permute(0, 2, 1, 3).reshape(b * 2, n, 1, 4).contiguous()
        gw = rw.permute(0, 2, 1, 3).reshape(b * 2, n, 1, 4).contiguous()
        out += [torch.ops.wm.flash_attention_rel_pos(q, k, v, gh, gw, 0.2),
                torch.ops.wm.windowed_attention_rel_pos(q, k, v, gh, gw,
                                                        0.2),
                torch.ops.wm.fused_mlp(x.reshape(-1, x.shape[-1]), w1, b1,
                                       w2, b2)]
        return out


def test_module_of_operators_exports_with_a_symbolic_batch():
    args = _op_args("flash_attention_packed", torch.float32, batch=2)[:3]
    mlp = _op_args("fused_mlp", torch.float32)
    x = mlp[0].reshape(2, 16, 64)
    batch = Dim("batch")
    spec = {"qkv": {0: batch}, "rh": {0: batch}, "rw": {0: batch},
            "x": {0: batch}, "w1": None, "b1": None, "w2": None, "b2": None}
    program = torch.export.export(_AllOps(), (*args, x, *mlp[1:]),
                                  dynamic_shapes=spec)
    targets = collections.Counter(
        str(n.target) for n in program.graph.nodes
        if str(n.target).startswith("wm."))
    assert targets == {f"wm.{name}.default": 1 for name in _library.OPS
                       if name != "flash_attention_packed"} | {
        "wm.flash_attention_packed.lse": 1}
    for b in (1, 3):
        new = _op_args("flash_attention_packed", torch.float32, batch=b,
                       seed=b)[:3]
        xb = torch.randn(b, 16, 64)
        got = program.module()(*new, xb, *mlp[1:])
        want = _AllOps()(*new, xb, *mlp[1:])
        for g, w in zip(got, want):
            assert g.shape[0] in (b, 2 * b, 16 * b) and torch.equal(g, w)


# ---- the model through the operators ------------------------------------------

def _route_through_functions(monkeypatch):
    """Send the model's kernel calls into the wrappers' autograd functions,
    as a CUDA tensor does (the wrappers themselves run the plain version for
    a CPU tensor): there the forward enters its `wm::` operator."""
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 64)

    def packed(wrapper):
        return lambda qkv, rh, rw, scale, heads, hw: \
            w2.PackedAttentionFn.apply(qkv, rh, rw, float(scale), heads,
                                       wrapper)

    def grouped(wrapper):
        def route(q, k, v, rh, rw, scale, hw):
            rh, rw = fa._check(q, k, v, rh, rw, hw)
            return fa.GroupedAttentionFn.apply(
                q.contiguous(), k.contiguous(), v.contiguous(),
                rh.contiguous(), rw.contiguous(), float(scale), wrapper)
        return route

    monkeypatch.setattr(tvit, "windowed_attention_packed",
                        packed(w2.windowed_attention_packed))
    monkeypatch.setattr(tvit, "flash_attention_packed",
                        packed(f2.flash_attention_packed))
    monkeypatch.setattr(tvit, "flash_attention_rel_pos",
                        grouped(fa.flash_attention_rel_pos))
    monkeypatch.setattr(tvit, "windowed_attention_rel_pos",
                        grouped(wa.windowed_attention_rel_pos))
    monkeypatch.setattr(common, "fused_mlp",
                        lambda *a: fm._FusedMlpFn.apply(*a))
    monkeypatch.setattr(adaptor, "cross_attention_packed",
                        lambda q, k, v, s, h: ca._CrossAttentionFn.apply(
                            q, k, v, float(s), h))


# one forward of the tiny model (img 128: windows of 16 tokens, one global
# block of 64; the adaptor's one head of 32, a head dim the kernels take)
# through the operators, by layout
PER_FORWARD = {
    "packed": {"windowed_attention_packed": 1, "flash_attention_packed": 1,
               "fused_mlp": 2, "cross_attention_packed": 1},
    "grouped": {"windowed_attention_rel_pos": 1,
                "flash_attention_rel_pos": 1, "cross_attention_packed": 1},
}


@pytest.mark.parametrize("layout", list(PER_FORWARD))
def test_model_exports_through_the_operators(monkeypatch, layout):
    cfg = tiny_config(tcfg, use_flash_attention=True, attn_impl=layout)
    cfg = dataclasses.replace(cfg, hfc=dataclasses.replace(cfg.hfc,
                                                           num_heads=1))
    model = WildlifeMapper(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu").eval()
    xs = {b: to_torch(_inputs(b, seed=b, img=128)) for b in (1, 3)}
    with torch.no_grad():
        plain = {b: model(x) for b, x in xs.items()}
    _route_through_functions(monkeypatch)
    program = texport.export_forward(model, batch_size=None)
    targets = collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if str(n.target).startswith("wm."))
    assert targets == PER_FORWARD[layout]
    assert not [n for n in program.graph.nodes
                if "scaled_dot_product" in str(n.target)]
    for b, x in xs.items():
        with torch.no_grad():
            got, routed = program.module()(x), model(x)
        for k in KEYS:
            assert torch.equal(got[k], routed[k]), (b, k)
            assert torch.equal(got[k], plain[b][k]), (b, k)

    # the program launches and counts when it runs: the operators' CUDA
    # implementations against a stand-in library, on these CPU tensors
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    before = {n: w.launches for n, w in _library.WRAPPERS.items()}
    module = program.module()
    assert before == {n: w.launches for n, w in _library.WRAPPERS.items()}
    with cuda_impls_on_cpu(*_library.OPS), torch.no_grad():
        module(xs[3])
    ran = {n: w.launches - before[n] for n, w in _library.WRAPPERS.items()}
    assert ran == {n: PER_FORWARD[layout].get(n, 0) for n in ran}
    assert len(lib.calls) == sum(PER_FORWARD[layout].values())


# ---- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["torch_checkpoint", "checkpoint"])
def test_cli_export(monkeypatch, tmp_path, weights):
    """cli/export.py on the tiny model (the variant's config replaced by it,
    the flags' canvas 128): a trainer's checkpoint file or a reference .pth
    in, a symbolic-batch program out, bit for bit the eager model with those
    weights."""
    monkeypatch.setattr(cli_train, "model_config",
                        lambda variant, **kw: dataclasses.replace(
                            tiny_config(tcfg), **kw))
    src = WildlifeMapper(tiny_config(tcfg, use_flash_attention=True),
                         generator=torch.Generator().manual_seed(3),
                         device="cpu").eval()
    ckpt = tmp_path / "weights.pth"
    torch.save({"model": {"module." + k: v for k, v in
                          src.state_dict().items()}} if weights ==
               "checkpoint" else src.state_dict(), ckpt)
    out = cli_export.main(["--out", str(tmp_path / "m.pt2"),
                           "--polymorphic_batch", "--device", "cpu",
                           "--canvas_size", "128", "--num_queries", "7",
                           f"--{weights}", str(ckpt)])
    program = texport.load_exported(out)
    x = to_torch(_inputs(2, seed=4, img=128))
    with torch.no_grad():
        got, want = program(x), src(x)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
