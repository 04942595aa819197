"""The port's .pth reader (wildlifemapper_tpu_torch/compat/torch_convert.py)
against the JAX package's converter: the same file, written here from a
seeded JAX initialisation in the reference's names
(weights.state_dict_from_jax), goes through `convert_checkpoint` of both
packages onto the same initial weights; the port's state dict must equal
`state_dict_from_jax` of the JAX result bit for bit, and the entries kept at
their initial values must be the same. Covers both file flavours (a trained
checkpoint's {model, optimizer, epoch} with DDP `module.` prefixes, a bare
state dict), raw SAM surgery, partial files, a shape mismatch, and the
rel-pos centre slice of a window-14 table into a window-12 model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.compat import torch_convert as jconv
from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.compat import torch_convert as tconv
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.torch_common import flat_numpy, perturbed, tiny_config

DEPTH = 2
# the decoder heads raw SAM carries and the surgery drops (build_sam.py:314)
SAM_HEADS = {"mask_decoder.iou_token.weight": (1, 32),
             "mask_decoder.mask_tokens.weight": (4, 32),
             "mask_decoder.output_upscaling.0.weight": (32, 8, 2, 2),
             "mask_decoder.iou_prediction_head.layers.0.weight": (32, 32),
             "prompt_encoder.point_embeddings.0.weight": (1, 32)}


def _configs(window):
    return (tiny_config(jcfg, window_size=window),
            tiny_config(tcfg, window_size=window))


@pytest.fixture(scope="module")
def inits():
    """JAX initialisations of the tiny model, by window: the file's
    (perturbed, key 0) and the target's (key 1)."""
    out = {}
    for window in (4, 12, 14):
        jc, _ = _configs(window)
        m = JaxWildlifeMapper(jc)
        x = jnp.zeros((1, jc.img_size, jc.img_size, 3))
        init = jax.jit(m.init)
        out[window] = (perturbed(init(jax.random.PRNGKey(0), x),
                                 np.random.default_rng(window)),
                       init(jax.random.PRNGKey(1), x))
    return out


def _reference_sd(params):
    return state_dict_from_jax(flat_numpy(params), depth=DEPTH)


def _file_contents(case, sd):
    """(what torch.save writes, whether SAM surgery is expected)."""
    if case == "trained_module_prefix":
        return {"model": {"module." + k: v for k, v in sd.items()},
                "optimizer": {}, "epoch": 3}, False
    if case == "bare_state_dict":
        return dict(sd), False
    if case == "raw_sam":
        raw = {k: v for k, v in sd.items() if "hfc" not in k}
        for k, shape in SAM_HEADS.items():
            raw[k] = torch.ones(shape)
        return raw, True
    if case == "partial_trained":
        # test_convert.py::test_convert_checkpoint_file_roundtrip's keys
        keep = ("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
                "mask_decoder.mask_tokens.weight",
                "image_encoder.hfc_attn.norm1.weight")
        return {"model": {"module." + k: sd[k] for k in keep}}, False
    if case == "adaptor_mha_only":
        # test_convert.py::test_mha_packed_split's keys
        return {k: v for k, v in sd.items()
                if "hfc_attn.cross_attn" in k}, False
    raise ValueError(case)


def _convert_both(tmp_path, contents, dst_params, dst_window):
    path = tmp_path / "ckpt.pth"
    torch.save(contents, path)
    tc = _configs(dst_window)[1]
    jnew, jrep = jconv.convert_checkpoint(str(path), dst_params, depth=DEPTH)
    tm = WildlifeMapper(tc, device="cpu")
    load_reference_state_dict(tm, _reference_sd(dst_params))
    trep = tconv.convert_checkpoint(str(path), tm)
    return jnew, jrep, tm, trep


def _assert_same_result(jnew, jrep, tm, trep, dst_params):
    want = _reference_sd(jnew)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    dst_flat = flat_numpy(dst_params)
    jmissing = state_dict_from_jax({k: dst_flat[k] for k in jrep["missing"]},
                                   depth=DEPTH)
    assert sorted(trep["missing"]) == sorted(jmissing)
    assert len(trep["loaded"]) + len(trep["missing"]) == len(got)


@pytest.mark.parametrize("case", ["trained_module_prefix", "bare_state_dict",
                                  "raw_sam", "partial_trained",
                                  "adaptor_mha_only"])
def test_convert_checkpoint_matches_jax(case, inits, tmp_path):
    src, dst = inits[4]
    contents, surgery = _file_contents(case, _reference_sd(src))
    jnew, jrep, tm, trep = _convert_both(tmp_path, contents, dst, 4)
    _assert_same_result(jnew, jrep, tm, trep, dst)
    if case in ("trained_module_prefix", "bare_state_dict"):
        assert not trep["missing"] and not trep["unexpected"]
    if surgery:
        # the fresh hfc_* parameters and decoder heads are named and kept
        assert {k for k in trep["missing"] if "hfc" in k}
        assert "mask_decoder.class_embed.layers.0.weight" in trep["missing"]
        assert "mask_decoder.mask_tokens.weight" in trep["missing"]
        assert trep["unexpected"] == ["prompt_encoder.point_embeddings.0."
                                      "weight"]


def test_rel_pos_centre_slice_window_14_into_12(inits, tmp_path):
    """A window-14 file's 27-row windowed tables load into a window-12
    model's 23 rows by the centre slice, in both packages alike."""
    src, _ = inits[14]
    _, dst = inits[12]
    sd = _reference_sd(src)
    assert sd["image_encoder.blocks.0.attn.rel_pos_h"].shape[0] == 27
    jnew, jrep, tm, trep = _convert_both(tmp_path, dict(sd), dst, 12)
    _assert_same_result(jnew, jrep, tm, trep, dst)
    table = sd["image_encoder.blocks.0.attn.rel_pos_h"]
    assert torch.equal(tm.image_encoder.blocks[0].attn.rel_pos_h,
                       table[2:25])


def test_shape_mismatch_raises_in_both(inits, tmp_path):
    src, dst = inits[4]
    sd = _reference_sd(src)
    sd["mask_decoder.mask_tokens.weight"] = torch.zeros(3, 5)
    path = tmp_path / "bad.pth"
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        jconv.convert_checkpoint(str(path), dst, depth=DEPTH)
    tm = WildlifeMapper(_configs(4)[1], device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tconv.convert_checkpoint(str(path), tm)


@pytest.mark.parametrize("fn", ["strip_prefixes", "apply_sam_surgery"])
def test_key_rules_match_jax(fn):
    """test_convert.py's prefix and surgery cases: the same keys kept."""
    sd = {"module.image_encoder.pos_embed": 1, "image_encoder.x": 2,
          "mask_decoder.iou_token.weight": 0,
          "mask_decoder.mask_tokens.weight": 0,
          "mask_decoder.transformer.layers.0.self_attn.q_proj.weight": 0,
          "mask_decoder.output_upscaling.0.weight": 0,
          "image_encoder.pos_embed": 0}
    assert getattr(tconv, fn)(sd) == getattr(jconv, fn)(sd)


def test_load_torch_file_unwraps_trained_checkpoints(tmp_path):
    sd = {"a": torch.arange(3.0), "b": np.ones(2, np.float32)}
    torch.save({"model": sd, "optimizer": {}, "epoch": 3}, tmp_path / "t.pth")
    got = tconv.load_torch_file(str(tmp_path / "t.pth"))
    want = jconv.load_torch_file(str(tmp_path / "t.pth"))
    assert sorted(got) == sorted(want) == ["a", "b"]
    for k in got:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_model_keeps_its_init_for_missing_entries():
    """strict=False: what the file lacks keeps the model's values, and the
    model's buffers and parameters stay where they are."""
    tm = WildlifeMapper(tiny_config(tcfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    gm = torch.randn(2, 16)
    rep = tconv.merge_state_dict(tm, {
        "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": gm})
    assert rep["loaded"] == [
        "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    assert len(rep["missing"]) == len(before) - 1
    for k, v in tm.state_dict().items():
        assert torch.equal(v, gm if k in rep["loaded"] else before[k]), k


def test_converted_model_gives_jax_logits(inits, tmp_path):
    """A model loaded from the file gives the JAX model's logits on the same
    input (the converted weights are the function's, not just its names)."""
    src, dst = inits[4]
    jc, tc = _configs(4)
    path = tmp_path / "w.pth"
    torch.save(_file_contents("trained_module_prefix",
                              _reference_sd(src))[0], path)
    tm = WildlifeMapper(tc, device="cpu").eval()
    tconv.convert_checkpoint(str(path), tm)
    x = np.random.default_rng(0).normal(
        size=(1, jc.img_size, jc.img_size, 3)).astype(np.float32)
    want = JaxWildlifeMapper(jc).apply(src, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-3)
