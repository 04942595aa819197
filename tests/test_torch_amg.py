"""The port's AMG utilities (wildlifemapper_tpu_torch/compat/amg.py) and the
box helpers beside them (ops/boxes.py: masks_to_boxes, box_xyxy_to_cxcywh)
against the JAX package's (wildlifemapper_tpu/compat/amg.py,
wildlifemapper_tpu/ops/boxes.py) on the same seeded numpy inputs: equal
exactly, the crop boxes in the same order, and the RLE codec round-tripping
in both packages and across them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu.compat import amg as jamg
from wildlifemapper_tpu.ops import boxes as jboxes
from wildlifemapper_tpu_torch.compat import amg as tamg
from wildlifemapper_tpu_torch.ops import boxes as tboxes


@pytest.mark.parametrize("n", [1, 4, 7, 32])
def test_point_grid(n):
    np.testing.assert_array_equal(tamg.build_point_grid(n),
                                  jamg.build_point_grid(n))


@pytest.mark.parametrize("n,layers,scale", [(8, 2, 2), (32, 3, 2), (5, 1, 3)])
def test_all_layer_point_grids(n, layers, scale):
    got = tamg.build_all_layer_point_grids(n, layers, scale)
    want = jamg.build_all_layer_point_grids(n, layers, scale)
    assert len(got) == len(want) == layers + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _masks(seed):
    rng = np.random.default_rng(seed)
    out = [rng.random((13, 17)) > rng.uniform(0.2, 0.8) for _ in range(10)]
    out += [np.ones((3, 3), bool), np.zeros((3, 5), bool),
            np.zeros((0, 4), bool), np.eye(6, dtype=bool)]
    return out


def test_rle_matches_and_round_trips():
    for m in _masks(0):
        got, want = tamg.mask_to_rle(m), jamg.mask_to_rle(m)
        assert got == want
        assert tamg.area_from_rle(got) == jamg.area_from_rle(want) \
            == int(m.sum())
        np.testing.assert_array_equal(tamg.rle_to_mask(got), m)
        np.testing.assert_array_equal(tamg.rle_to_mask(want),
                                      jamg.rle_to_mask(got))
    assert tamg.mask_to_rle(np.ones((3, 3), bool))["counts"][0] == 0


def test_stability_score():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 5, 9, 11)).astype(np.float32)
    logits[0, 0] = -5.0                     # both masks empty: 1.0
    for t, off in ((0.0, 0.1), (0.3, 1.0), (-0.2, 0.05)):
        got = tamg.calculate_stability_score(torch.from_numpy(logits), t, off)
        want = jamg.calculate_stability_score(jnp.asarray(logits), t, off)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[0, 0]) == 1.0


def test_boxes_of_masks():
    rng = np.random.default_rng(2)
    m = rng.random((2, 3, 8, 10)) > 0.93
    m[0, 1] = False                          # an empty mask: zeros
    got = tamg.batched_mask_to_box(torch.from_numpy(m))
    want = jamg.batched_mask_to_box(jnp.asarray(m))
    assert tuple(got.shape) == want.shape == (2, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = m.reshape(6, 8, 10)
    np.testing.assert_array_equal(
        tboxes.masks_to_boxes(torch.from_numpy(flat)).numpy(),
        np.asarray(jboxes.masks_to_boxes(jnp.asarray(flat))))


def test_box_xyxy_to_cxcywh():
    b = np.random.default_rng(3).uniform(0, 100, (4, 5, 4)).astype(np.float32)
    got = tboxes.box_xyxy_to_cxcywh(torch.from_numpy(b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jboxes.box_xyxy_to_cxcywh(jnp.asarray(b))))
    np.testing.assert_allclose(tboxes.box_cxcywh_to_xyxy(got).numpy(), b,
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("size,layers,overlap", [
    ((100, 200), 2, 0.25), ((3648, 5472), 1, 512 / 1500),
    ((1024, 1024), 3, 0.1), ((37, 91), 2, 0.0)])
def test_crop_boxes_in_order(size, layers, overlap):
    got = tamg.generate_crop_boxes(size, layers, overlap)
    assert got == jamg.generate_crop_boxes(size, layers, overlap)
    boxes, idx = got
    assert idx == sorted(idx) and idx.count(layers) == 4 ** layers


def test_uncrop():
    bx = np.asarray([[1.0, 2.0, 3.0, 4.0], [5.5, 6.0, 7.0, 8.25]],
                    np.float32)
    crop = [10, 20, 50, 60]
    np.testing.assert_array_equal(
        tamg.uncrop_boxes_xyxy(torch.from_numpy(bx), crop).numpy(),
        np.asarray(jamg.uncrop_boxes_xyxy(jnp.asarray(bx), crop)))
    np.testing.assert_array_equal(
        tamg.uncrop_points(torch.from_numpy(bx[:, :2]), crop).numpy(),
        np.asarray(jamg.uncrop_points(jnp.asarray(bx[:, :2]), crop)))
