"""The port's interactive predictor (wildlifemapper_tpu_torch/compat/
predictor.py) against the JAX package's (wildlifemapper_tpu/compat/
predictor.py) on the tiny config of tests/test_model.py:14 (img 64, grid 4),
with the kernels' plain versions on the port's side and the Pallas kernels
as the JAX tests run them on the CPU, perturbed JAX weights carried across:

  * on the same preprocessed canvas (an image whose resize is the identity
    in both packages), the image embedding and every detection within atol
    1e-4 / rtol 1e-3 of the JAX predictor's, with and without NMS;
  * the two resizes apart: the port's antialiased bilinear
    (data/transforms.py::resize_uint8) against PIL's BILINEAR, as the JAX
    predictor calls it, within one uint8 level;
  * in every configuration (full canvas, content crop, crop prologue),
    `predict` bit for bit what `postprocess(model(canvas))` and
    `batched_nms` give on the same canvas, and the predictor's API."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.compat.predictor import \
    WildlifeMapperPredictor as JaxPredictor
from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.compat.predictor import WildlifeMapperPredictor
from wildlifemapper_tpu_torch.data.transforms import (normalize_image,
                                                      pad_to_canvas,
                                                      resize_keep_aspect,
                                                      resize_uint8)
from wildlifemapper_tpu_torch.eval.postprocess import (batched_nms,
                                                       postprocess)
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.torch_common import flat_numpy, perturbed, tiny_config

TOL = dict(atol=1e-4, rtol=1e-3)
# an image the tiny config's 48-in-64 content extent keeps at its size
SAME_SIZE = (36, 48)


def _config(mod, **overrides):
    """tests/test_model.py:14's tiny config: tests/torch_common.py's at
    img 64, with the kernels on."""
    return dataclasses.replace(
        tiny_config(mod, use_flash_attention=True, **overrides), img_size=64)


@pytest.fixture(scope="module")
def predictors():
    jc, tc = _config(jcfg), _config(tcfg)
    jm = JaxWildlifeMapper(jc)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        np.zeros((1, 64, 64, 3), np.float32)),
                       np.random.default_rng(0), scale=0.2)
    tm = WildlifeMapper(tc, device="cpu")
    load_reference_state_dict(tm, state_dict_from_jax(flat_numpy(params),
                                                      depth=2))
    return JaxPredictor(jm, params, jc), WildlifeMapperPredictor(tm.eval())


def _image(seed, hw=SAME_SIZE):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3),
                                                dtype=np.uint8)


def test_embedding_and_detections_match_jax(predictors):
    jp, tp = predictors
    img = _image(0)
    jp.set_image(img)
    tp.set_image(img)
    np.testing.assert_allclose(
        tp.get_image_embedding().float().numpy(),
        np.asarray(jp.get_image_embedding()), **TOL)
    for kw in (dict(score_threshold=0.0, apply_nms=False),
               dict(score_threshold=0.0, apply_nms=True, nms_iou=0.4),
               dict(score_threshold=0.15, apply_nms=True, nms_iou=0.7)):
        got, want = tp.predict(**kw), jp.predict(**kw)
        assert len(got["boxes"]) == len(want["boxes"]), kw
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert len(tp.predict(score_threshold=0.0, apply_nms=False)["boxes"]) \
        == 7


@pytest.mark.parametrize("hw", [(120, 160), (1000, 1500), (37, 30)])
def test_resize_within_one_level_of_pil(hw):
    """The port's resize against PIL's, as each predictor resizes an image
    to the content extent; kept apart from the model's tolerance."""
    img = _image(1, hw)
    for target in (48, 768):
        ow, oh = resize_keep_aspect((hw[1], hw[0]), target, target)
        got = resize_uint8(img, ow, oh)
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BILINEAR))
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_preprocess_is_the_pipeline(predictors):
    _, tp = predictors
    img = _image(2, (120, 160))
    canvas = tp.preprocess(img)
    want = pad_to_canvas(normalize_image(resize_uint8(img, 48, 36)), 64)
    assert canvas.shape == (1, 64, 64, 3) and canvas.dtype == torch.float32
    np.testing.assert_array_equal(canvas[0].numpy(), want)
    np.testing.assert_array_equal(tp.preprocess(_image(3))[0].numpy(),
                                  pad_to_canvas(normalize_image(_image(3)),
                                                64))


@pytest.mark.parametrize("which", ["full_canvas", "compat_crop",
                                   "crop_prologue"])
def test_predict_is_forward_postprocess_nms(which):
    """In every configuration the predictor's halves are the detector's
    forward: the same detections bit for bit."""
    overrides = {"full_canvas": {},
                 "compat_crop": dict(content_size=48),
                 "crop_prologue": dict(content_size=48, crop_prologue=True,
                                       no_scramble=True)}[which]
    tm = WildlifeMapper(_config(tcfg, **overrides),
                        generator=torch.Generator().manual_seed(4),
                        device="cpu").eval()
    tp = WildlifeMapperPredictor(tm)
    img = _image(5, (120, 160))
    canvas = tp.preprocess(img)
    tp.set_image(img)
    with torch.inference_mode():
        out = tm(canvas)
        assert torch.equal(tp.get_image_embedding(), tm.encode(canvas))
    for thr, nms in ((0.0, False), (0.0, True), (0.12, True)):
        got = tp.predict(score_threshold=thr, apply_nms=nms)
        dets = postprocess(out, torch.tensor([[120, 160]]), thr,
                           hw_swap_compat=False)
        keep = dets["keep"]
        if nms:
            keep = batched_nms(dets["boxes"], dets["scores"], dets["labels"],
                               keep, 0.4, class_aware=False)
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(got[k], dets[k][0][keep[0]].numpy())


def test_predictor_api(predictors):
    _, tp = predictors
    tp.reset_image()
    assert not tp.is_image_set
    with pytest.raises(RuntimeError, match="set_image"):
        tp.predict()
    with pytest.raises(RuntimeError, match="set_image"):
        tp.get_image_embedding()
    tp.set_image(_image(6, (120, 160)))
    assert tp.is_image_set
    assert tp.get_image_embedding().shape == (1, 4, 4, 32)
    out = tp.predict(score_threshold=0.0)
    assert out["boxes"].shape[1] == 4 and len(out["boxes"]) > 0
    assert out["boxes"].dtype == np.float32 and out["labels"].dtype == np.int32
    tp.reset_image()
    assert not tp.is_image_set
