"""The grouped attention layout (attn_impl="grouped") of the port against the
JAX package: the plain versions of the two grouped kernels (K5
flash_attention_rel_pos, K6 windowed_attention_rel_pos) against the Pallas
kernels in interpret mode, forward (float32 at atol 2e-5 / rtol 1e-4,
bfloat16 at 2e-2) and backward (against jax.vjp of the Pallas function, all
five inputs, atol 5e-4 / rtol 1e-3); RelPosAttention, Block, the tiny model
and one train step with attn_impl="grouped" against the JAX modules built
the same way; and what the layout must not change: the outputs (grouped
equals packed in float32) and the parameter set."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildlifemapper_tpu.models.vit as jvit
import wildlifemapper_tpu_torch.models.vit as tvit
from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu.ops import flash_attention as jflash
from wildlifemapper_tpu.ops import windowed_attention as jwin
from wildlifemapper_tpu.train import step as jstep
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.ops import _attention
from wildlifemapper_tpu_torch.ops.flash_attention import (
    flash_attention_rel_pos, flash_attention_rel_pos_backward_plain,
    flash_attention_rel_pos_plain, reference_attention_rel_pos)
from wildlifemapper_tpu_torch.ops.windowed_attention import (
    windowed_attention_rel_pos, windowed_attention_rel_pos_backward_plain,
    windowed_attention_rel_pos_plain)
from wildlifemapper_tpu_torch.train import step as tstep
from wildlifemapper_tpu_torch.train.synthetic import training_config
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.torch_common import (flat_numpy, perturbed, port_state_dict,
                                tiny_config, to_numpy, to_torch)

TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GROUPED = dict(use_flash_attention=True, attn_impl="grouped")


def _inputs(seed, bh, hw, d):
    """q, k, v (BH, N, d) and the rel tables (BH, N, h) / (BH, N, w)."""
    rng = np.random.default_rng(seed)
    n = hw[0] * hw[1]
    q, k, v = (rng.normal(size=(bh, n, d)).astype(np.float32)
               for _ in range(3))
    rel_h = (rng.normal(size=(bh, n, hw[0])) * 0.5).astype(np.float32)
    rel_w = (rng.normal(size=(bh, n, hw[1])) * 0.5).astype(np.float32)
    return q, k, v, rel_h, rel_w


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---- the kernels' plain versions, forward -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,hw,d", [
    (4, (8, 8), 32),
    (2, (4, 16), 16),      # non-square: the Pallas expansion-matmul branch
    (3, (8, 8), 64),
    # the head dims of the f32 forward body (64, ViT-H's 80) on a grid of
    # rows 24 wide (a divisor of the 48-grid's, 48-key tiles)
    (2, (4, 24), 64),
    (2, (4, 24), 80),
])
def test_flash_plain_matches_pallas(dtype, bh, hw, d):
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(bh + d, bh, hw, d)
    scale = d ** -0.5
    want = jflash.flash_attention_rel_pos(
        *[jnp.asarray(a, jdt) for a in arrays], scale, hw)
    got = flash_attention_rel_pos_plain(
        *[to_torch(a, tdt) for a in arrays], scale, hw)
    assert got.dtype == tdt and got.shape == arrays[0].shape
    np.testing.assert_allclose(to_numpy(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bwh,hw,d", [
    (19, (4, 4), 32),      # not a multiple of the Pallas group of 16
    (6, (3, 3), 16),
    (3, (2, 4), 64),       # rectangular window
    (2, (8, 8), 32),       # a global block below GLOBAL_N_THRESHOLD
    (5, (7, 7), 80),       # ViT-H's head dim on a ragged window
])
def test_windowed_plain_matches_pallas(dtype, bwh, hw, d):
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(bwh + d, bwh, hw, d)
    scale = d ** -0.5
    want = jwin.windowed_attention_rel_pos(
        *[jnp.asarray(a, jdt) for a in arrays], scale, hw)
    got = windowed_attention_rel_pos_plain(
        *[to_torch(a, tdt) for a in arrays], scale, hw)
    assert got.dtype == tdt and got.shape == arrays[0].shape
    np.testing.assert_allclose(to_numpy(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("bh,hw,d", [(3, (8, 8), 32), (2, (4, 16), 16),
                                    (2, (4, 24), 64), (1, (4, 24), 80)])
def test_flash_lse_matches_jax_residual(bh, hw, d):
    """The lse the forward hands to the backward kernels is the JAX
    residual m + log l (flash_attention.py:252)."""
    arrays = _inputs(5, bh, hw, d)
    _, res = jflash._flash_fwd(*map(jnp.asarray, arrays), 0.25, hw)
    want = np.asarray(res[6])[..., 0]
    _, lse = flash_attention_rel_pos_plain(*map(to_torch, arrays), 0.25, hw,
                                           return_lse=True)
    assert lse.shape == (bh, hw[0] * hw[1]) and lse.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(lse), want, atol=2e-5, rtol=1e-5)


def test_reference_oracle_matches_jax_oracle():
    arrays = _inputs(9, 2, (4, 8), 16)
    rh4 = arrays[3].reshape(2, 4, 8, 4)      # the encoder's 4-D tables
    want = jflash.reference_attention_rel_pos(
        *map(jnp.asarray, arrays[:3]), jnp.asarray(rh4),
        jnp.asarray(arrays[4]), 0.25, (4, 8))
    got = reference_attention_rel_pos(
        *map(to_torch, arrays[:3]), to_torch(rh4), to_torch(arrays[4]), 0.25,
        (4, 8))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               **TOL["float32"])
    plain = flash_attention_rel_pos_plain(*map(to_torch, arrays), 0.25,
                                          (4, 8))
    np.testing.assert_allclose(to_numpy(plain), np.asarray(want),
                               **TOL["float32"])


# ---- the kernels' plain versions, backward ------------------------------------

def _vjp(fn, arrays, dout, scale, hw):
    _, pullback = jax.vjp(lambda *a: fn(*a, scale, hw),
                          *map(jnp.asarray, arrays))
    return pullback(jnp.asarray(dout))


NAMES = ("dq", "dk", "dv", "drel_h", "drel_w")


@pytest.mark.parametrize("table_dims", [3, 4])
@pytest.mark.parametrize("bh,hw,d", [(2, (4, 4), 16), (2, (4, 16), 16),
                                     (3, (8, 8), 64)])
def test_flash_backward_plain_matches_pallas_vjp(table_dims, bh, hw, d):
    """All five gradients; with 4-D tables (BH, qh, qw, W), as the encoder
    passes them, the table gradients come back 4-D."""
    q, k, v, rel_h, rel_w = _inputs(bh * d, bh, hw, d)
    if table_dims == 4:
        rel_h = rel_h.reshape(bh, *hw, hw[0])
        rel_w = rel_w.reshape(bh, *hw, hw[1])
    arrays = (q, k, v, rel_h, rel_w)
    dout = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    scale = d ** -0.5
    want = _vjp(jflash.flash_attention_rel_pos, arrays, dout, scale, hw)
    tens = [to_torch(a) for a in arrays]
    out, lse = flash_attention_rel_pos_plain(*tens, scale, hw,
                                             return_lse=True)
    got = flash_attention_rel_pos_backward_plain(*tens, out, lse,
                                                 to_torch(dout), scale, hw)
    for name, g, w, a in zip(NAMES, got, want, arrays):
        assert g.shape == a.shape, name
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("bwh,hw,d", [
    (19, (4, 4), 16), (5, (3, 3), 32), (2, (2, 4), 64), (5, (7, 7), 80),
    # the windows the f32 window body takes on the card (2 windows of 2
    # heads): 14 x 14 and 12 x 12 at head dim 64 and 80
    (4, (14, 14), 64), (4, (12, 12), 64), (4, (14, 14), 80),
    (4, (12, 12), 80)])
def test_windowed_backward_plain_matches_pallas_vjp(bwh, hw, d):
    """The Pallas backward recomputes the softmax and takes delta = sum
    p*dp; the port's takes the forward's lse and rowsum(do*o): the same
    gradients."""
    arrays = _inputs(bwh * d, bwh, hw, d)
    dout = np.random.default_rng(2).normal(
        size=arrays[0].shape).astype(np.float32)
    scale = d ** -0.5
    want = _vjp(jwin.windowed_attention_rel_pos, arrays, dout, scale, hw)
    tens = [to_torch(a) for a in arrays]
    out, lse = windowed_attention_rel_pos_plain(*tens, scale, hw,
                                                return_lse=True)
    got = windowed_attention_rel_pos_backward_plain(
        *tens, out, lse, to_torch(dout), scale, hw)
    for name, g, w, a in zip(NAMES, got, want, arrays):
        assert g.shape == a.shape, name
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("which", ["flash", "windowed"])
def test_autograd_through_cpu_wrapper_is_the_plain_backward(which):
    """On the CPU autograd differentiates the plain forward; the hand-written
    plain backward, which the CUDA kernels are held to, is the same
    function."""
    wrapper, backward = {
        "flash": (flash_attention_rel_pos,
                  flash_attention_rel_pos_backward_plain),
        "windowed": (windowed_attention_rel_pos,
                     windowed_attention_rel_pos_backward_plain)}[which]
    hw, scale = (4, 6), 0.2
    tens = [to_torch(a).requires_grad_() for a in _inputs(3, 3, hw, 16)]
    dout = to_torch(np.random.default_rng(4).normal(size=tens[0].shape))
    got = torch.autograd.grad(wrapper(*tens, scale, hw), tens, dout)
    with torch.no_grad():
        out, lse = flash_attention_rel_pos_plain(*tens, scale, hw,
                                                 return_lse=True)
        want = backward(*tens, out, lse, dout, scale, hw)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, **GRAD_TOL, msg=name)


# ---- the wrappers' dispatch and checks ----------------------------------------

WRAPPERS = {"flash": (flash_attention_rel_pos, flash_attention_rel_pos_plain),
            "windowed": (windowed_attention_rel_pos,
                         windowed_attention_rel_pos_plain)}


@pytest.mark.parametrize("which", list(WRAPPERS))
def test_wrapper_dispatch(which):
    """CPU tensors take the plain version and launch nothing; a tensor on
    another device is refused rather than sent to the plain version."""
    wrapper, plain = WRAPPERS[which]
    args = [to_torch(a) for a in _inputs(0, 3, (4, 4), 32)]
    before = (wrapper.launches, wrapper.backward_dq_launches,
              wrapper.backward_dkv_launches)
    torch.testing.assert_close(wrapper(*args, 0.25, (4, 4)),
                               plain(*args, 0.25, (4, 4)), rtol=0, atol=0)
    assert before == (wrapper.launches, wrapper.backward_dq_launches,
                      wrapper.backward_dkv_launches)
    with pytest.raises(ValueError, match="no kernel for device"):
        wrapper(*[a.to("meta") for a in args], 0.25, (4, 4))


@pytest.mark.parametrize("which", list(WRAPPERS))
@pytest.mark.parametrize("fault", ["grid", "k", "rel_h", "rel_w", "no_table"])
def test_wrapper_refuses_bad_shapes(which, fault):
    wrapper, _ = WRAPPERS[which]
    q, k, v, rel_h, rel_w = (to_torch(a) for a in _inputs(0, 2, (4, 4), 32))
    hw = (4, 4)
    if fault == "grid":
        hw = (4, 5)
    elif fault == "k":
        k = k[:, :8]
    elif fault == "rel_h":
        rel_h = rel_h[..., :3]
    elif fault == "rel_w":
        rel_w = rel_w[:1]
    else:
        rel_h = None
    with pytest.raises(ValueError):
        wrapper(q, k, v, rel_h, rel_w, 0.25, hw)


def test_windowed_wrapper_takes_3d_tables_only():
    q, k, v, rel_h, rel_w = (to_torch(a) for a in _inputs(0, 2, (4, 4), 32))
    with pytest.raises(ValueError, match="rel_h is not"):
        windowed_attention_rel_pos(q, k, v, rel_h.reshape(2, 4, 4, 4), rel_w,
                                   0.25, (4, 4))


def test_launch_refuses_a_batch_beyond_the_grid_limit():
    """The batch rides blockIdx.z: more than 65535 window-heads are refused
    before anything is built or launched."""
    bh = _attention.MAX_GRID_YZ + 1
    q = torch.zeros(bh, 1, 32)
    rel = torch.zeros(bh, 1, 1, 1)
    with pytest.raises(ValueError, match="at most 65535"):
        _attention.attention_launch(q, q, q, 1.0, 1, rel, rel,
                                    scale_scores=True)


# ---- the modules --------------------------------------------------------------

def _pair(jmod, tmod, jax_prefix, torch_prefix, x, seed=0):
    rng = np.random.default_rng(seed)
    params = perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tmod.load_state_dict(port_state_dict(params, jax_prefix, torch_prefix))
    want = jmod.apply(params, jnp.asarray(x))
    with torch.inference_mode():
        got = tmod(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               **TOL["float32"])


@pytest.mark.parametrize("window", [4, 3])
def test_rel_pos_attention_grouped_windowed(window, rng):
    x = rng.normal(size=(5, window, window, 64)).astype(np.float32)
    _pair(jvit.RelPosAttention(dim=64, num_heads=2,
                               input_size=(window, window), use_flash=True,
                               attn_impl="grouped"),
          tvit.RelPosAttention(64, 2, (window, window), use_flash=True,
                               attn_impl="grouped"),
          "image_encoder/blocks_0/attn/", "image_encoder.blocks.0.attn.", x)


@pytest.mark.parametrize("grid", [8, 6])   # 6: centre-sliced rel tables
def test_rel_pos_attention_grouped_global(grid, rng, monkeypatch):
    """Above a patched GLOBAL_N_THRESHOLD the grouped path takes K5."""
    monkeypatch.setattr(jvit, "GLOBAL_N_THRESHOLD", 36)
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 36)
    calls = []
    monkeypatch.setattr(
        tvit, "flash_attention_rel_pos",
        lambda *a: calls.append(1) or flash_attention_rel_pos(*a))
    x = rng.normal(size=(2, grid, grid, 64)).astype(np.float32)
    _pair(jvit.RelPosAttention(dim=64, num_heads=2, input_size=(grid, grid),
                               table_size=(8, 8), use_flash=True,
                               attn_impl="grouped"),
          tvit.RelPosAttention(64, 2, (8, 8), use_flash=True,
                               attn_impl="grouped"),
          "image_encoder/blocks_0/attn/", "image_encoder.blocks.0.attn.", x)
    assert calls == [1]


@pytest.mark.parametrize("window,grid", [(4, 8), (3, 8), (0, 8), (0, 6)])
def test_block_grouped(window, grid, rng, monkeypatch):
    """Windowed blocks and global blocks below the threshold take K6; the
    MLP of a grouped block is the plain one."""
    calls = []
    monkeypatch.setattr(
        tvit, "windowed_attention_rel_pos",
        lambda *a: calls.append(1) or windowed_attention_rel_pos(*a))
    x = rng.normal(size=(2, grid, grid, 64)).astype(np.float32)
    tblock = tvit.Block(64, 2, window_size=window, table_size=(8, 8),
                        use_flash=True, attn_impl="grouped")
    assert not tblock.mlp.use_fused
    _pair(jvit.Block(dim=64, num_heads=2, window_size=window,
                     input_size=(grid, grid), table_size=(8, 8),
                     use_flash=True, attn_impl="grouped"),
          tblock, "image_encoder/blocks_0/", "image_encoder.blocks.0.", x)
    assert calls == [1]


def test_global_attention_without_rel_pos_is_unsupported(monkeypatch):
    """The JAX package cannot run this combination either (its global
    kernel reads the tables' shapes); the port says so."""
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 36)
    for impl in ("packed", "grouped"):
        attn = tvit.RelPosAttention(64, 2, (8, 8), use_rel_pos=False,
                                    use_flash=True, attn_impl=impl)
        with pytest.raises(ValueError, match="unsupported"):
            attn(torch.zeros(1, 8, 8, 64))
        attn(torch.zeros(1, 4, 4, 64))       # below the threshold: plain


# ---- the slice ----------------------------------------------------------------

MODES = {
    "full_canvas": dict(),
    "compat_crop": dict(content_size=96),
    "from_scratch": dict(content_size=96, crop_prologue=True,
                         no_scramble=True, window_size=3),
}


def _canvas(seed, batch=2, content=96, canvas=128):
    x = np.zeros((batch, canvas, canvas, 3), np.float32)
    x[:, :content, :content] = np.random.default_rng(seed).normal(
        size=(batch, content, content, 3))
    return x


def _port_model(mode, params, depth, **extra):
    tm = WildlifeMapper(tiny_config(tcfg, **dict(MODES[mode]), **extra),
                        device="cpu")
    load_reference_state_dict(
        tm, state_dict_from_jax(flat_numpy(params), depth=depth))
    return tm


@pytest.mark.parametrize("mode", list(MODES))
def test_slice_grouped_matches_jax_and_packed(mode, monkeypatch):
    """The tiny model end to end with attn_impl="grouped" (the global block
    through K5, the windows through K6) against the JAX package built the
    same way, and against the port's packed layout on the same weights."""
    monkeypatch.setattr(jvit, "GLOBAL_N_THRESHOLD", 32)
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 32)
    jc = tiny_config(jcfg, **dict(MODES[mode]), **GROUPED)
    x = _canvas(11)
    jm = JaxWildlifeMapper(jc)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)),
                       np.random.default_rng(4))
    jout = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.inference_mode():
        tout = _port_model(mode, params, jc.vit.depth, **GROUPED)(to_torch(x))
        pout = _port_model(mode, params, jc.vit.depth,
                           use_flash_attention=True)(to_torch(x))
    for k in ("pred_logits", "pred_boxes"):
        assert tout[k].dtype == torch.float32
        np.testing.assert_allclose(to_numpy(tout[k]), np.asarray(jout[k]),
                                   atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(to_numpy(tout[k]), to_numpy(pout[k]),
                                   atol=1e-4, rtol=1e-3)


def test_bf16_grouped_slice_close_to_jax_bf16(monkeypatch):
    monkeypatch.setattr(jvit, "GLOBAL_N_THRESHOLD", 32)
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 32)
    extra = dict(GROUPED, dtype="bfloat16")
    jc = tiny_config(jcfg, content_size=96, **extra)
    x = _canvas(11)
    jm = JaxWildlifeMapper(jc)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)),
                       np.random.default_rng(4))
    jout = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.inference_mode():
        tout = _port_model("compat_crop", params, jc.vit.depth,
                           **extra)(to_torch(x))
    np.testing.assert_allclose(to_numpy(tout["pred_boxes"]),
                               _f32(jout["pred_boxes"]), atol=2e-2)
    np.testing.assert_allclose(to_numpy(tout["pred_logits"]),
                               _f32(jout["pred_logits"]), atol=5e-2)


def test_state_dict_is_the_same_for_both_layouts():
    """attn_impl changes the data flow, not the parameters: same names,
    same shapes, and one layout's weights load into the other."""
    packed = WildlifeMapper(tiny_config(tcfg, use_flash_attention=True),
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    grouped = WildlifeMapper(tiny_config(tcfg, **GROUPED), device="cpu")
    psd, gsd = packed.state_dict(), grouped.state_dict()
    assert list(psd) == list(gsd)
    assert all(psd[k].shape == gsd[k].shape for k in psd)
    grouped.load_state_dict(psd, strict=True)


def test_training_config_takes_the_grouped_layout():
    """No knob of its own: the caller replaces attn_impl on the model."""
    cfg = training_config("from_scratch", dtype="float32")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attn_impl="grouped"))
    assert cfg.model.use_flash_attention and cfg.model.attn_impl == "grouped"
    assert cfg.model.vit.window_size == 12


# ---- one train step -------------------------------------------------------------

def _batch(seed=0, b=2, t=6, counts=(4, 2)):
    rng = np.random.default_rng(seed)
    image = np.zeros((b, 128, 128, 3), np.float32)
    image[:, :96, :96] = rng.normal(size=(b, 96, 96, 3))
    boxes = rng.uniform(0.15, 0.6, size=(b, t, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.3
    return {"image": image,
            "labels": rng.integers(1, 7, size=(b, t)).astype(np.int32),
            "boxes": boxes,
            "valid": np.arange(t)[None, :] < np.asarray(counts)[:, None]}


def test_train_step_grouped_matches_jax(monkeypatch):
    """One whole train step, nothing frozen (so the rel tables and every
    block weight get gradients through the grouped kernels' backward):
    losses and grad_norm at rtol 1e-4, every gradient at atol 1e-5 / rtol
    1e-3, against the JAX StepBuilder with attn_impl="grouped"."""
    monkeypatch.setattr(jvit, "GLOBAL_N_THRESHOLD", 32)
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 32)
    cfgs = []
    for mod in (jcfg, tcfg):
        model = tiny_config(mod, **GROUPED)
        model = dataclasses.replace(
            model, hfc=dataclasses.replace(model.hfc, dropout=0.0))
        cfgs.append(mod.Config(model=model, train=mod.TrainConfig(
            freeze_encoder=False, clip_max_norm=1e9)))
    jc, tc = cfgs
    jb = jstep.StepBuilder(jc)
    params = perturbed(jb.init_params(jax.random.PRNGKey(0)),
                       np.random.default_rng(4))
    jstate = jb.init_state(params, steps_per_epoch=10)
    tb = tstep.StepBuilder(tc, device="cpu")
    load_reference_state_dict(
        tb.model, state_dict_from_jax(flat_numpy(params), depth=2))
    tstate = tb.init_state(steps_per_epoch=10)
    batch = _batch()
    key = jax.random.PRNGKey(1)

    def loss_fn(tr):
        from wildlifemapper_tpu.train.criterion import set_criterion
        out = jb.model.apply({"params": tr}, jnp.asarray(batch["image"]),
                             deterministic=False, rngs={"dropout": key})
        tgt = {k: jnp.asarray(batch[k]) for k in ("labels", "boxes", "valid")}
        return set_criterion(out, tgt, jc.criterion,
                             num_classes=jc.model.num_classes)["loss"]

    jgrads = jax.grad(loss_fn)(params["params"])
    _, jmetrics = jax.jit(jb.train_step_fn())(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    _, tmetrics = tb.train_step(
        tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    gsd = state_dict_from_jax(flat_numpy({"params": jgrads}), depth=2)
    rel = 0
    for n, p in tb.model.named_parameters():
        np.testing.assert_allclose(to_numpy(p.grad), to_numpy(gsd[n]),
                                   atol=1e-5, rtol=1e-3, err_msg=n)
        if "rel_pos" in n:
            rel += 1
            assert float(p.grad.abs().sum()) > 0, n
    assert rel == 4
