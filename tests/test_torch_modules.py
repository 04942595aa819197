"""Each port module that holds a kernel (MLPBlock, RelPosAttention windowed
and global, Block, CrossAttentionHfcPatch with and without the scramble),
plus Neck, PositionEmbeddingRandom and BoxDecoder, against the JAX module
with the same seeded weights, float32 at atol 2e-5 / rtol 1e-4. With
use_flash the port runs its kernels' plain versions here (CPU tensors); the
JAX side runs its Pallas kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildlifemapper_tpu.models.vit as jvit
import wildlifemapper_tpu_torch.models.vit as tvit
from wildlifemapper_tpu.models import adaptor as jadaptor
from wildlifemapper_tpu.models import common as jcommon
from wildlifemapper_tpu.models import decoder as jdecoder
from wildlifemapper_tpu.models import pos_embed as jpos
from wildlifemapper_tpu_torch.models import adaptor as tadaptor
from wildlifemapper_tpu_torch.models import common as tcommon
from wildlifemapper_tpu_torch.models import decoder as tdecoder
from wildlifemapper_tpu_torch.models import pos_embed as tpos

from tests.torch_common import perturbed, port_state_dict, to_numpy, to_torch

TOL = dict(atol=2e-5, rtol=1e-4)


def _pair(jmod, tmod, jax_prefix, torch_prefix, *inputs, seed=0,
          scale=0.05, **kw):
    """Init the JAX module, perturb its params, move them to the port
    module, run both on the same inputs."""
    rng = np.random.default_rng(seed)
    jin = [jnp.asarray(x) for x in inputs]
    params = perturbed(jmod.init(jax.random.PRNGKey(0), *jin, **kw), rng,
                       scale)
    tmod.load_state_dict(port_state_dict(params, jax_prefix, torch_prefix))
    want = jmod.apply(params, *jin, **kw)
    with torch.inference_mode():
        got = tmod(*[to_torch(x) for x in inputs], **kw)
    return got, want


def _close(got, want):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_fused", [False, True])
def test_mlp_block(use_fused, rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    got, want = _pair(
        jcommon.MLPBlock(mlp_dim=256, out_dim=64, use_fused=use_fused),
        tcommon.MLPBlock(64, 256, use_fused=use_fused),
        "image_encoder/blocks_0/mlp/", "image_encoder.blocks.0.mlp.", x)
    _close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("window", [4, 3])
def test_rel_pos_attention_windowed(use_flash, window, rng):
    x = rng.normal(size=(5, window, window, 64)).astype(np.float32)
    got, want = _pair(
        jvit.RelPosAttention(dim=64, num_heads=2, input_size=(window, window),
                             use_flash=use_flash),
        tvit.RelPosAttention(64, 2, (window, window), use_flash=use_flash),
        "image_encoder/blocks_0/attn/", "image_encoder.blocks.0.attn.", x)
    _close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("grid", [8, 6])   # 6: centre-sliced rel tables
def test_rel_pos_attention_global(use_flash, grid, rng, monkeypatch):
    """The global-kernel dispatch, with GLOBAL_N_THRESHOLD patched in both
    packages so small grids take it (tests/test_flash_attention_v2.py:129
    does the same)."""
    monkeypatch.setattr(jvit, "GLOBAL_N_THRESHOLD", 36)
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 36)
    x = rng.normal(size=(2, grid, grid, 64)).astype(np.float32)
    got, want = _pair(
        jvit.RelPosAttention(dim=64, num_heads=2, input_size=(grid, grid),
                             table_size=(8, 8), use_flash=use_flash),
        tvit.RelPosAttention(64, 2, (8, 8), use_flash=use_flash),
        "image_encoder/blocks_0/attn/", "image_encoder.blocks.0.attn.", x)
    _close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("window,grid", [(4, 8), (3, 8), (0, 8), (0, 6)])
def test_block(use_flash, window, grid, rng):
    """Windowed blocks (4 tiles the grid, 3 pads 8 -> 9) and global blocks
    below GLOBAL_N_THRESHOLD, which take the windowed kernel."""
    x = rng.normal(size=(2, grid, grid, 64)).astype(np.float32)
    got, want = _pair(
        jvit.Block(dim=64, num_heads=2, window_size=window,
                   input_size=(grid, grid), table_size=(8, 8),
                   use_flash=use_flash),
        tvit.Block(64, 2, window_size=window, table_size=(8, 8),
                   use_flash=use_flash),
        "image_encoder/blocks_0/", "image_encoder.blocks.0.", x)
    _close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("scrambled", [True, False])
def test_cross_attention_hfc_patch(use_flash, scrambled, rng):
    hfc = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    patch = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    got, want = _pair(
        jadaptor.CrossAttentionHfcPatch(
            d_model=64, proj_dim=32, num_heads=2, ffn_dim=32, grid_size=8,
            use_flash=use_flash, compat_scrambled_reshape=scrambled),
        tadaptor.CrossAttentionHfcPatch(
            d_model=64, hfc_dim=32, proj_dim=32, num_heads=2, ffn_dim=32,
            grid_size=8, use_flash=use_flash,
            compat_scrambled_reshape=scrambled),
        "image_encoder/hfc_attn/", "image_encoder.hfc_attn.", hfc, patch)
    _close(got, want)


def test_neck(rng):
    x = rng.normal(size=(2, 6, 6, 64)).astype(np.float32)
    got, want = _pair(jvit.Neck(out_chans=32), tvit.Neck(64, 32),
                      "image_encoder/neck/", "image_encoder.neck.", x)
    _close(got, want)


def test_position_embedding_random():
    rng = np.random.default_rng(5)
    jmod = jpos.PositionEmbeddingRandom(num_pos_feats=16, grid_size=8)
    params = perturbed(jmod.init(jax.random.PRNGKey(0)), rng, 1.0)
    tmod = tpos.PositionEmbeddingRandom(16)
    tmod.load_state_dict(port_state_dict(params, "pos_encoder/",
                                         "prompt_encoder.pe_layer."))
    _close(tmod(8), jmod.apply(params))


@pytest.mark.parametrize("aux_loss", [False, True])
def test_box_decoder(aux_loss, rng):
    emb = rng.normal(size=(2, 6, 6, 32)).astype(np.float32)
    pe = rng.normal(size=(6, 6, 32)).astype(np.float32)
    kw = dict(transformer_dim=32, num_queries=7, num_logits=8,
              head_hidden_dim=32, head_depth=3, depth=2, num_heads=2,
              mlp_dim=64, aux_loss=aux_loss)
    got, want = _pair(jdecoder.BoxDecoder(**kw), tdecoder.BoxDecoder(**kw),
                      "box_decoder/", "mask_decoder.", emb, pe)
    for k in ("pred_logits", "pred_boxes"):
        _close(got[k], want[k])
    assert len(got.get("aux_outputs", [])) == len(want.get("aux_outputs", []))
    for g, w in zip(got.get("aux_outputs", []), want.get("aux_outputs", [])):
        for k in ("pred_logits", "pred_boxes"):
            _close(g[k], w[k])
