"""remat_blocks in the port (models/vit.py: Block, two segments of
torch.utils.checkpoint a block that keep its input and its attention
output): the same function as without it, and the JAX package's remat
train step at ViT-H's head dim.

What is compared, and how tightly:
  * the port's train step with remat_blocks against the same step without
    it, at the tiny width of tests/torch_common.py, float32, in both
    layouts and with the encoder frozen or not: losses at rtol 1e-6 and
    every gradient at rtol 1e-6 (the JAX package's own remat test holds
    its loss at rtol 1e-6, tests/test_train_loop.py:354);
  * the port's train step against the JAX package's at head dim 80 (D
    160, 2 heads of 80, depth 2, one global block), weights carried across
    by `state_dict_from_jax`, in the fine-tune (frozen encoder, remat) and
    from scratch in ViT-H's shape (crop prologue, windows of 12 on a
    24-grid: four windows of 144 and a global block of 576, every
    parameter trained, the encoder's gradients included; remat on and off
    on both sides): losses at atol 1e-4 / rtol 1e-3 and every trainable
    gradient at atol 5e-4 / rtol 1e-3 (the tolerances of record for the
    model and for gradients); the JAX side runs its Pallas kernels as its
    own tests run them on the CPU;
  * the fused MLP's forward within `outputs_unread` (the recompute of the
    MLP segment): no launch, the same gradients.
Every comparison with the JAX package sets hfc.dropout = 0.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.models import vit as jvit
from wildlifemapper_tpu.train import step as jstep
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.models import vit as tvit
from wildlifemapper_tpu_torch.ops import _build, fused_mlp as fmlp
from wildlifemapper_tpu_torch.train import step as tstep
from wildlifemapper_tpu_torch.train.synthetic import training_config
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.test_torch_attention_bodies import (_StandInLibrary,
                                              cuda_impls_on_cpu)
from tests.test_torch_train_step import (_batch, _jax_batch, _jax_params,
                                         _port_state_dict, _torch_batch,
                                         jcrit_loss)
from tests.torch_common import tiny_config, to_numpy


def _remat_configs(mod, remat, use_flash, head_dim=32, attn_impl="packed",
                   from_scratch=False, **train):
    """The tiny Config of tests/torch_common.py (2 heads; width 2 x
    head_dim), hfc.dropout 0, no clipping, in one package. `from_scratch`
    gives it the from-scratch shape of train/synthetic.py at a quarter of
    ViT-H's grid: a 512 canvas with 384-px content (crop prologue, the
    24-grid), windows of 12, the unscrambled adaptor reshape."""
    model = tiny_config(mod, use_flash_attention=use_flash,
                        attn_impl=attn_impl, remat_blocks=remat)
    model = dataclasses.replace(
        model, vit=dataclasses.replace(model.vit, embed_dim=2 * head_dim),
        hfc=dataclasses.replace(model.hfc, dropout=0.0))
    if from_scratch:
        model = dataclasses.replace(
            model, img_size=SCRATCH_CANVAS, content_size=SCRATCH_CONTENT,
            crop_prologue=True,
            vit=dataclasses.replace(model.vit, window_size=12),
            hfc=dataclasses.replace(model.hfc,
                                    compat_scrambled_reshape=False))
    return mod.Config(model=model, train=mod.TrainConfig(clip_max_norm=1e9,
                                                         **train))


SCRATCH_CANVAS, SCRATCH_CONTENT = 512, 384


def _port_step(cfg, sd, batch):
    tb = tstep.StepBuilder(cfg, device="cpu")
    load_reference_state_dict(tb.model, sd)
    state = tb.init_state(steps_per_epoch=10)
    _, metrics = tb.train_step(state, _torch_batch(batch))
    grads = {n: p.grad for n, p in tb.model.named_parameters()
             if p.grad is not None}
    return tb.model, metrics, grads


@pytest.mark.parametrize("use_flash,attn_impl,freeze", [
    (False, "packed", True), (True, "packed", True),
    (True, "packed", False), (True, "grouped", False)])
def test_remat_step_equals_the_step_without_it(monkeypatch, use_flash,
                                               attn_impl, freeze):
    """remat_blocks changes what the backward keeps, not the function: the
    same losses and every gradient at rtol 1e-6 (the global block goes
    through K2 / K5 and the windows through K1 / K6)."""
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 32)
    _, params = _jax_params(_remat_configs(jcfg, False, use_flash))
    sd = _port_state_dict(params["params"])
    batch = _batch(seed=2)
    runs = [_port_step(_remat_configs(tcfg, remat, use_flash,
                                      attn_impl=attn_impl,
                                      freeze_encoder=freeze), sd, batch)
            for remat in (False, True)]
    (m0, metrics0, g0), (m1, metrics1, g1) = runs
    assert m1.config.remat_blocks and not m0.config.remat_blocks
    assert all(blk.remat for blk in m1.image_encoder.blocks)
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm"):
        np.testing.assert_allclose(float(metrics1[k]), float(metrics0[k]),
                                   rtol=1e-6, err_msg=k)
    assert set(g0) == set(g1) and len(g0) > 20
    for n in g0:
        np.testing.assert_allclose(to_numpy(g1[n]), to_numpy(g0[n]),
                                   rtol=1e-6, atol=0, err_msg=n)
    # the frozen encoder's blocks take no gradient either way
    assert freeze == all(n not in g1 for n in g1
                         if n.startswith("image_encoder.blocks."))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("setup,remat", [("fine_tune", True),
                                         ("from_scratch", True),
                                         ("from_scratch", False)])
def test_remat_step_matches_jax_at_head_dim_80(monkeypatch, setup, remat,
                                                use_flash):
    """The port's step against the JAX package's at ViT-H's head dim: D 160
    in 2 heads of 80, depth 2 with one global block (through K2 and K1
    with the kernels' plain versions here, Pallas in the JAX package). The
    fine-tune freezes the encoder and runs remat; from scratch trains
    every parameter in ViT-H's from-scratch shape (windows of 12 x 12 = 144
    tokens, the global block on the 24-grid), with remat on and off."""
    scratch = setup == "from_scratch"
    # windows of 144 below the threshold, the global 576 above it
    threshold = 200 if scratch else 32
    monkeypatch.setattr(jvit, "GLOBAL_N_THRESHOLD", threshold)
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", threshold)
    jc, tc = (_remat_configs(mod, remat, use_flash, head_dim=80,
                             from_scratch=scratch, freeze_encoder=not scratch)
              for mod in (jcfg, tcfg))
    assert jc.model.vit.embed_dim // jc.model.vit.num_heads == 80
    jb, params = _jax_params(jc)
    jstate = jb.init_state(params, steps_per_epoch=10)
    batch = (_batch(seed=4, size=SCRATCH_CANVAS, content=SCRATCH_CONTENT)
             if scratch else _batch(seed=4))
    trainable, frozen = jstep._split_params(jstate.params, not scratch)

    def loss_fn(tr):
        out = jb.model.apply(jstep._merge_params(tr, frozen),
                             jnp.asarray(batch["image"]), deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(1)})
        tgt = {k: jnp.asarray(batch[k]) for k in ("labels", "boxes", "valid")}
        return jcrit_loss(out, tgt, jc)

    jloss, jgrads = jax.value_and_grad(loss_fn)(trainable)
    _, jmetrics = jax.jit(jb.train_step_fn())(jstate, _jax_batch(batch),
                                              jax.random.PRNGKey(1))
    model, metrics, grads = _port_step(tc, _port_state_dict(params["params"]),
                                       batch)
    assert model.config.remat_blocks == remat
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               atol=1e-4, rtol=1e-3)
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=1e-4, rtol=1e-3, err_msg=k)
    want = state_dict_from_jax({k: np.asarray(v) for k, v in jgrads.items()},
                               depth=2)
    encoder = [n for n in grads if n.startswith("image_encoder.blocks.")]
    assert grads and bool(encoder) == scratch
    if scratch:
        assert set(grads) == set(want)
        assert {n for n, p in model.named_parameters()} == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(to_numpy(g), to_numpy(want[n]), atol=5e-4,
                                   rtol=1e-3, err_msg=n)


def test_mlp_forward_within_outputs_unread_launches_nothing(monkeypatch):
    """The MLP segment's recompute: within `outputs_unread` the fused MLP's
    autograd function saves its inputs and launches no kernel (the stand-in
    library records none and `launches` stays), and its backward (with the
    dh kernel's plain version here) gives the gradients it gives without
    the context: it does not read the output. The output it returns there
    is an explicit zero that holds no memory. The forward's operator runs
    its CUDA implementation (the launcher and the count) on these CPU
    tensors, as it does on the card."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fmlp, "fused_mlp_dh", lambda x_, w1_, b1_, da, _:
                        fmlp.fused_mlp_dh_plain(x_, w1_, b1_, da))
    gen = torch.Generator().manual_seed(0)
    x, w1, b1, w2, b2 = (torch.randn(*s, generator=gen) for s in
                         ((16, 64), (128, 64), (128,), (64, 128), (64,)))
    g = torch.randn(16, 64, generator=gen)
    grads, launched = [], []
    for unread in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
        before = fmlp.fused_mlp.launches
        lib.calls.clear()
        with (fmlp.outputs_unread() if unread
              else contextlib.nullcontext()), cuda_impls_on_cpu("fused_mlp"):
            out = fmlp._FusedMlpFn.apply(*leaves)
        launched.append(([name for name, _ in lib.calls],
                         fmlp.fused_mlp.launches - before))
        if unread:
            assert out.shape == x.shape and out.dtype == x.dtype
            assert out.stride() == (0, 0) and not out.any()
        out.backward(g)
        grads.append([t.grad for t in leaves])
    assert launched == [(["wm_fused_mlp_fwd"], 1), ([], 0)]
    assert not getattr(fmlp._state, "outputs_unread", False)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_training_config_variants():
    """training_config at ViT-H's published width and depth (the new
    path: the fine-tune with remat_blocks), and ViT-B as before."""
    fine = training_config("fine_tune", variant="vit_h", remat_blocks=True)
    vit = fine.model.vit
    assert (vit.embed_dim, vit.depth, vit.num_heads) == (1280, 32, 16)
    assert vit.global_attn_indexes == (7, 15, 23, 31)
    assert fine.model.remat_blocks and fine.train.freeze_encoder
    assert fine.model.use_flash_attention and fine.model.dtype == "bfloat16"
    scratch = training_config("from_scratch", variant="vit_h")
    assert scratch.model.vit.window_size == 12
    assert scratch.model.vit.embed_dim == 1280
    assert not scratch.model.remat_blocks
    vit_b = training_config("fine_tune")
    assert vit_b.model.vit.embed_dim == 768 and not vit_b.model.remat_blocks
