"""The port's whole serving slice (forward + postprocess + NMS) against the
JAX package with the same seeded weights, in the three configurations of
bench.py at a tiny width (img 128, 96-px content: grid 8 cropped to 6),
float32 at atol 1e-4 / rtol 1e-3. Also the weight conversion, the loader,
the refusal of the unported grouped kernels, and that the port never
imports JAX."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.compat.torch_convert import (map_torch_keys,
                                                     merge_into_params)
from wildlifemapper_tpu.eval import postprocess as jpost
from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.eval import postprocess as tpost
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.torch_common import (flat_numpy, perturbed, tiny_config, to_numpy,
                                to_torch)

TOL = dict(atol=1e-4, rtol=1e-3)
# bench.py's three configurations, cut to the tiny width: full canvas,
# checkpoint-compat crop, from-scratch crop_prologue with a window that
# tiles the content grid (12 on the 48-grid there, 3 on the 6-grid here).
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


def _models(mode, **extra):
    jc = tiny_config(jcfg, **dict(MODES[mode]), **extra)
    tc = tiny_config(tcfg, **dict(MODES[mode]), **extra)
    x = _canvas(11)
    jm = JaxWildlifeMapper(jc)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)),
                       np.random.default_rng(4))
    tm = WildlifeMapper(tc)
    load_reference_state_dict(
        tm, state_dict_from_jax(flat_numpy(params), depth=jc.vit.depth))
    return jm, params, tm, x


def _post_jax(out, sizes, hw_swap, class_aware):
    dets = jpost.postprocess(out, jnp.asarray(sizes), 0.05,
                             hw_swap_compat=hw_swap)
    dets["keep"] = jpost.batched_nms(dets["boxes"], dets["scores"],
                                     dets["labels"], dets["keep"], 0.4,
                                     class_aware=class_aware)
    return dets


def _post_port(out, sizes, hw_swap, class_aware):
    dets = tpost.postprocess(out, torch.as_tensor(sizes), 0.05,
                             hw_swap_compat=hw_swap)
    dets["keep"] = tpost.batched_nms(dets["boxes"], dets["scores"],
                                     dets["labels"], dets["keep"], 0.4,
                                     class_aware=class_aware)
    return dets


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("use_flash", [True, False])
def test_slice_matches_jax(mode, use_flash):
    jm, params, tm, x = _models(mode, use_flash_attention=use_flash)
    sizes = np.array([[128, 96], [100, 128]], np.int32)   # non-square
    jout = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.inference_mode():
        tout = tm(to_torch(x))
    for k in ("pred_logits", "pred_boxes"):
        assert tout[k].dtype == torch.float32
        np.testing.assert_allclose(to_numpy(tout[k]), np.asarray(jout[k]),
                                   **TOL)
    for hw_swap, class_aware in ((True, False), (False, True)):
        jdets = _post_jax(jout, sizes, hw_swap, class_aware)
        with torch.inference_mode():
            tdets = _post_port(tout, sizes, hw_swap, class_aware)
        np.testing.assert_allclose(to_numpy(tdets["scores"]),
                                   np.asarray(jdets["scores"]), **TOL)
        np.testing.assert_allclose(to_numpy(tdets["boxes"]),
                                   np.asarray(jdets["boxes"]), atol=1e-2,
                                   rtol=1e-3)  # pixels: 1e-4 of 128 px
        np.testing.assert_array_equal(tdets["labels"].numpy(),
                                      np.asarray(jdets["labels"]))
        np.testing.assert_array_equal(tdets["keep"].numpy(),
                                      np.asarray(jdets["keep"]))


@pytest.mark.parametrize("hw_swap", [True, False])
@pytest.mark.parametrize("class_aware", [True, False])
def test_postprocess_nms_match_jax_exactly(hw_swap, class_aware):
    """On identical model outputs the two post-processing paths agree:
    scores, labels, boxes and the NMS keep mask, over dense overlaps."""
    rng = np.random.default_rng(int(hw_swap) * 2 + int(class_aware))
    logits = rng.normal(size=(3, 51, 8)).astype(np.float32) * 2
    boxes = np.concatenate(
        [rng.uniform(0.3, 0.7, size=(3, 51, 2)),
         rng.uniform(0.05, 0.3, size=(3, 51, 2))], -1).astype(np.float32)
    sizes = np.array([[1024, 1024], [600, 800], [768, 512]], np.int32)
    outputs = {"pred_logits": logits, "pred_boxes": boxes}
    jd = jpost.postprocess({k: jnp.asarray(v) for k, v in outputs.items()},
                           jnp.asarray(sizes), 0.05, hw_swap_compat=hw_swap)
    td = tpost.postprocess({k: to_torch(v) for k, v in outputs.items()},
                           torch.as_tensor(sizes), 0.05,
                           hw_swap_compat=hw_swap)
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(to_numpy(td[k]), np.asarray(jd[k]),
                                   atol=1e-5, rtol=1e-6)
    for k in ("labels", "keep"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    jk = jpost.batched_nms(jd["boxes"], jd["scores"], jd["labels"],
                           jd["keep"], 0.4, class_aware=class_aware)
    tk = tpost.batched_nms(td["boxes"], td["scores"], td["labels"],
                           td["keep"], 0.4, class_aware=class_aware)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() < td["keep"].sum()   # NMS did suppress something


def test_weights_roundtrip_exact():
    """state_dict_from_jax is the exact inverse of map_torch_keys, and the
    result merges strictly into the JAX parameter tree."""
    jc = tiny_config(jcfg)
    jm = JaxWildlifeMapper(jc)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 128, 128, 3))),
                       np.random.default_rng(0))
    flat = flat_numpy(params)
    sd = state_dict_from_jax(flat, depth=jc.vit.depth)
    back = map_torch_keys({k: v.numpy() for k, v in sd.items()},
                          depth=jc.vit.depth)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    _, report = merge_into_params(params, back, strict=True)
    assert not report["missing"] and not report["unexpected"]
    # and the port's own parameter set is exactly these names
    tm = WildlifeMapper(tiny_config(tcfg))
    assert sorted(tm.state_dict()) == sorted(sd)


def test_loader_drops_iou_token_and_slices_windows():
    tm = WildlifeMapper(tiny_config(tcfg, window_size=3),
                        generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    sd["mask_decoder.iou_token.weight"] = torch.zeros(1, 32)
    table = torch.arange(7 * 32, dtype=torch.float32).reshape(7, 32)
    sd["image_encoder.blocks.0.attn.rel_pos_h"] = table   # window-4 table
    assert load_reference_state_dict(tm, sd) == []
    torch.testing.assert_close(tm.image_encoder.blocks[0].attn.rel_pos_h,
                               table[1:6])
    del sd["image_encoder.neck.0.weight"]
    with pytest.raises(KeyError, match="neck.0.weight"):
        load_reference_state_dict(tm, sd)


def test_grouped_kernels_not_ported():
    tm = WildlifeMapper(tiny_config(tcfg, use_flash_attention=True,
                                    attn_impl="grouped"))
    with pytest.raises(NotImplementedError, match="K5"):
        with torch.inference_mode():
            tm(torch.zeros(1, 128, 128, 3))


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port and ends with
    no jax, flax or PIL module loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import wildlifemapper_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'PIL', 'wildlifemapper_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_bf16_slice_close_to_jax_bf16():
    """bf16 with the kernels' plain versions against the JAX bf16 path with
    its Pallas kernels: the same function at bf16 rounding."""
    jm, params, tm, x = _models("compat_crop", use_flash_attention=True,
                                dtype="bfloat16")
    jout = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.inference_mode():
        tout = tm(to_torch(x))
    np.testing.assert_allclose(to_numpy(tout["pred_boxes"]),
                               np.asarray(jout["pred_boxes"]), atol=2e-2)
    np.testing.assert_allclose(to_numpy(tout["pred_logits"]),
                               np.asarray(jout["pred_logits"]), atol=5e-2)
