"""The port's framework ops (wildlifemapper_tpu_torch/ops: hfc, boxes,
windows, rel_pos) and config against the JAX package's, on the same
seeded numpy inputs, at atol 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.ops import boxes as jboxes
from wildlifemapper_tpu.ops import hfc as jhfc
from wildlifemapper_tpu.ops import rel_pos as jrel
from wildlifemapper_tpu.ops import windows as jwin
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.ops import boxes as tboxes
from wildlifemapper_tpu_torch.ops import hfc as thfc
from wildlifemapper_tpu_torch.ops import rel_pos as trel
from wildlifemapper_tpu_torch.ops import windows as twin

from tests.torch_common import to_numpy, to_torch

ATOL = 1e-5


def test_config_copy_matches_jax():
    """The port's config copy has the JAX config's fields and defaults."""
    for name in ("ViTConfig", "HFCConfig", "DecoderConfig", "ModelConfig",
                 "EvalConfig"):
        j, t = getattr(jcfg, name), getattr(tcfg, name)
        assert ([f.name for f in dataclasses.fields(j)]
                == [f.name for f in dataclasses.fields(t)]), name
        assert dataclasses.asdict(j()) == dataclasses.asdict(t()), name
    for v in ("vit_b", "vit_l", "vit_h"):
        assert (dataclasses.asdict(jcfg.model_config(v))
                == dataclasses.asdict(tcfg.model_config(v)))
    # the training and data side: field for field ...
    for name in ("MatchCriterionConfig", "TrainConfig", "DataConfig"):
        j, t = getattr(jcfg, name), getattr(tcfg, name)
        assert ([f.name for f in dataclasses.fields(j)]
                == [f.name for f in dataclasses.fields(t)]), name
        jd, td = dataclasses.asdict(j()), dataclasses.asdict(t())
        if name == "DataConfig":
            # ... the port's annotations default to its own copy of the
            # vendored bundle, which the JAX default falls back to
            from wildlifemapper_tpu_torch.data.coco import ASSETS_DIR
            assert td.pop("coco_path") == str(ASSETS_DIR)
            jd.pop("coco_path")
        assert jd == td, name
    # ... and Config, its device mesh included
    jfields = [f.name for f in dataclasses.fields(jcfg.Config)]
    tfields = [f.name for f in dataclasses.fields(tcfg.Config)]
    assert tfields == jfields
    for f in tfields:
        if f != "data":
            assert (dataclasses.asdict(getattr(tcfg.Config(), f))
                    == dataclasses.asdict(getattr(jcfg.Config(), f))), f
    assert tcfg.model_config(dtype="bfloat16").compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tcfg.model_config(content_size=96, crop_prologue=True)


@pytest.mark.parametrize("method", ["matmul", "rfft", "fft"])
@pytest.mark.parametrize("hw", [(64, 64), (48, 40)])
def test_hfc_filter_matches_jax(method, hw):
    x = np.random.default_rng(3).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jhfc.hfc_filter(jnp.asarray(x), 0.125, method=method))
    got = to_numpy(thfc.hfc_filter(to_torch(x), 0.125, method=method))
    assert got.shape == want.shape == (2, *hw, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


def test_boxes_match_jax(rng):
    cxcywh = rng.uniform(0.1, 0.9, size=(3, 11, 4)).astype(np.float32)
    a = np.asarray(jboxes.box_cxcywh_to_xyxy(jnp.asarray(cxcywh)))
    b = to_numpy(tboxes.box_cxcywh_to_xyxy(to_torch(cxcywh)))
    np.testing.assert_allclose(b, a, atol=ATOL)
    np.testing.assert_allclose(to_numpy(tboxes.box_area(to_torch(a))),
                               np.asarray(jboxes.box_area(jnp.asarray(a))),
                               atol=ATOL)
    ji, ju = jboxes.box_iou_pairwise(jnp.asarray(a), jnp.asarray(a[:, ::-1]))
    ti, tu = tboxes.box_iou_pairwise(to_torch(a), to_torch(a[:, ::-1].copy()))
    np.testing.assert_allclose(to_numpy(ti), np.asarray(ji), atol=ATOL)
    np.testing.assert_allclose(to_numpy(tu), np.asarray(ju), atol=ATOL)


@pytest.mark.parametrize("grid,window", [(8, 4), (6, 4), (8, 3), (64, 14)])
def test_windows_match_jax(grid, window):
    x = np.random.default_rng(grid).normal(
        size=(2, grid, grid, 5)).astype(np.float32)
    jw, jpad = jwin.window_partition(jnp.asarray(x), window)
    tw, tpad = twin.window_partition(to_torch(x), window)
    assert tpad == jpad
    np.testing.assert_array_equal(to_numpy(tw), np.asarray(jw))
    back = twin.window_unpartition(tw, window, tpad, (grid, grid))
    np.testing.assert_array_equal(to_numpy(back), x)


def test_cached_constants_serve_autograd_after_inference_mode():
    """The device constants the ops cache (rel-pos gather index, HFC
    matrices) are first built under inference mode by a serving call and
    must still serve a later call that records autograd."""
    with torch.inference_mode():
        trel.select_rel_pos(torch.zeros(11, 4), 5, 5)
        thfc.hfc_filter(torch.zeros(1, 20, 20, 3))
    table = torch.randn(11, 4, requires_grad=True)
    trel.select_rel_pos(table, 5, 5).sum().backward()
    assert table.grad.abs().sum() > 0
    x = torch.randn(1, 20, 20, 3, requires_grad=True)
    thfc.hfc_filter(x).sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("q_size,k_size,table", [(4, 4, 7), (14, 14, 27),
                                                 (6, 6, 15), (3, 3, 9)])
def test_rel_pos_matches_jax(q_size, k_size, table):
    """Index table, gather (with the linear resample when the table does not
    fit), and the decomposed projections."""
    rng = np.random.default_rng(q_size * 100 + table)
    np.testing.assert_array_equal(trel.rel_pos_index(q_size, k_size),
                                  jrel.rel_pos_index(q_size, k_size))
    tab = rng.normal(size=(table, 8)).astype(np.float32)
    np.testing.assert_allclose(
        to_numpy(trel.select_rel_pos(to_torch(tab), q_size, k_size)),
        np.asarray(jrel.select_rel_pos(jnp.asarray(tab), q_size, k_size)),
        atol=ATOL)
    q = rng.normal(size=(3, q_size * q_size, 8)).astype(np.float32)
    th = rng.normal(size=(2 * q_size - 1, 8)).astype(np.float32)
    tw = rng.normal(size=(2 * q_size - 1, 8)).astype(np.float32)
    jh, jw = jrel.decomposed_rel_pos_tables(
        jnp.asarray(q), jnp.asarray(th), jnp.asarray(tw), (q_size, q_size),
        (q_size, q_size))
    th_, tw_ = trel.decomposed_rel_pos_tables(
        to_torch(q), to_torch(th), to_torch(tw), (q_size, q_size),
        (q_size, q_size))
    np.testing.assert_allclose(to_numpy(th_), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(to_numpy(tw_), np.asarray(jw), atol=ATOL)
    n = q_size * q_size
    attn = rng.normal(size=(3, n, n)).astype(np.float32)
    want = jrel.add_decomposed_rel_pos_matmul(jnp.asarray(attn), jh, jw,
                                              (q_size, q_size))
    got = trel.add_decomposed_rel_pos(to_torch(attn), th_, tw_)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL)
