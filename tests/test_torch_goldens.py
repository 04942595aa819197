"""The port against the goldens captured from the PyTorch reference
(tests/goldens/*.npz), at the tolerances of tests/test_goldens.py. The
goldens' state dicts carry the reference's names, which are the port's own,
so they load with no mapping."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.golden_common import meta_to_state_dict, moments, padded_canvas
from wildlifemapper_tpu_torch.config import model_config
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.models.adaptor import CrossAttentionHfcPatch
from wildlifemapper_tpu_torch.models.decoder import BoxDecoder
from wildlifemapper_tpu_torch.models.pos_embed import PositionEmbeddingRandom
from wildlifemapper_tpu_torch.models.vit import Block
from wildlifemapper_tpu_torch.ops.hfc import hfc_filter
from wildlifemapper_tpu_torch.weights import load_reference_state_dict

GOLDENS = Path(__file__).parent / "goldens"


def _sub(sd, prefix):
    return {k[len(prefix):]: torch.as_tensor(np.asarray(v))
            for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("which,window", [("windowed", 14), ("global", 0)])
@pytest.mark.parametrize("use_flash", [False, True])
def test_vit_block_goldens(which, window, use_flash):
    npz = np.load(GOLDENS / "vit_blocks.npz")
    sd = {k.split("::", 1)[1]: npz[k] for k in npz.files
          if k.startswith(f"{which}_sd::")}
    blk = Block(64, 4, window_size=window, table_size=(16, 16),
                use_flash=use_flash)
    blk.load_state_dict(_sub(sd, "image_encoder.blocks.0."))
    with torch.inference_mode():
        out = blk(torch.from_numpy(npz[f"{which}_x"]))
    np.testing.assert_allclose(out.numpy(), npz[f"{which}_y"], atol=2e-5,
                               rtol=1e-4)


def test_hfc_goldens():
    npz = np.load(GOLDENS / "hfc.npz")
    x_toy = np.ascontiguousarray(np.transpose(npz["x_toy"], (0, 2, 3, 1)))
    y = hfc_filter(torch.from_numpy(x_toy), 0.125)[..., 0].numpy()
    np.testing.assert_allclose(y, npz["y_toy"][:, 0], atol=1e-5, rtol=1e-4)
    y = hfc_filter(torch.from_numpy(padded_canvas(seed=223)), 0.125)
    y = y[..., 0].numpy()
    np.testing.assert_allclose(y[:, ::8, ::8], npz["y_strided"][:, 0],
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(moments(y), npz["y_moments"], atol=1e-6,
                               rtol=1e-5)


def test_dense_pe_goldens():
    npz = np.load(GOLDENS / "dense_pe.npz")
    sd = meta_to_state_dict(npz["meta"])
    pe = PositionEmbeddingRandom(128)
    pe.load_state_dict(_sub(sd, "prompt_encoder.pe_layer."))
    out = np.transpose(pe(64).numpy(), (2, 0, 1))
    np.testing.assert_allclose(out[:, ::4, ::4], npz["y_strided"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(moments(out), npz["y_moments"], atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_adaptor_goldens(use_flash):
    """Real dims (768/1024, grid 64) with the scrambled reshape; the
    tolerance is test_goldens.py's (4096-key softmax plus two LayerNorms on
    unit-scale inputs)."""
    npz = np.load(GOLDENS / "adaptor.npz")
    sd = meta_to_state_dict(npz["meta"])
    ad = CrossAttentionHfcPatch(d_model=768, hfc_dim=1024, proj_dim=1024,
                                num_heads=8, ffn_dim=1024, dropout=0.1,
                                grid_size=64, use_flash=use_flash)
    ad.load_state_dict(_sub(sd, "image_encoder.hfc_attn."))
    r = np.random.default_rng(211)
    hfc = r.normal(size=(1, 64, 64, 1024)).astype(np.float32)
    patch = r.normal(size=(1, 64, 64, 768)).astype(np.float32)
    with torch.inference_mode():
        out = ad(torch.from_numpy(hfc), torch.from_numpy(patch)).numpy()
    np.testing.assert_allclose(out[:, ::4, ::4, :], npz["out_strided"],
                               atol=1e-3, rtol=1e-2)
    np.testing.assert_allclose(moments(out), npz["out_moments"], atol=1e-3,
                               rtol=1e-2)


def test_decoder_goldens():
    npz = np.load(GOLDENS / "decoder.npz")
    sd = {k.split("::", 1)[1]: npz[k] for k in npz.files
          if k.startswith("sd::")}
    dec = BoxDecoder(transformer_dim=32, num_queries=7, num_logits=8,
                     head_hidden_dim=32, head_depth=3, depth=2, num_heads=4,
                     mlp_dim=64)
    sub = _sub(sd, "mask_decoder.")
    del sub["iou_token.weight"]   # vestigial in the reference
    dec.load_state_dict(sub)
    with torch.inference_mode():
        out = dec(torch.from_numpy(npz["emb"]), torch.from_numpy(npz["pe"]))
    np.testing.assert_allclose(out["pred_logits"].numpy(), npz["logits"],
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out["pred_boxes"].numpy(), npz["boxes"],
                               atol=2e-5, rtol=1e-4)


@pytest.mark.slow
def test_full_model_goldens():
    """Full ViT-B f32 forward of the port, kernel path (plain versions on
    the CPU), against the reference's own logits and boxes."""
    npz = np.load(GOLDENS / "full_model.npz")
    model = WildlifeMapper(model_config("vit_b", use_flash_attention=True))
    load_reference_state_dict(model, meta_to_state_dict(npz["meta"]))
    with torch.inference_mode():
        out = model(torch.from_numpy(padded_canvas(seed=107)))
    np.testing.assert_allclose(out["pred_logits"].numpy(), npz["logits"],
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out["pred_boxes"].numpy(), npz["boxes"],
                               atol=1e-4, rtol=1e-3)
