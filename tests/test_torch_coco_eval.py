"""The port's CocoEvaluator (wildlifemapper_tpu_torch/eval/coco_eval.py)
against the JAX package's, on the same predictions: the hand-computable
cases of tests/test_coco_eval.py, and perfect, random and category-sparse
predictions on the vendored val ground truth. The 12 summary stats and the
per-category AP agree to 1e-12 (the port always matches with the numpy
matcher; tests/test_native.py holds it equal to the JAX package's native
one)."""

import numpy as np
import pytest

from wildlifemapper_tpu.data.coco import ASSETS_DIR as JASSETS
from wildlifemapper_tpu.data.coco import CocoIndex as JIndex
from wildlifemapper_tpu.eval import coco_eval as jce
from wildlifemapper_tpu_torch.data.coco import ASSETS_DIR as TASSETS
from wildlifemapper_tpu_torch.data.coco import CocoIndex as TIndex
from wildlifemapper_tpu_torch.eval import coco_eval as tce

TOL = 1e-12


class FakeIndex:
    def __init__(self, anns_by_img, cats=(1, 2)):
        self._anns = anns_by_img
        self.categories = [{"id": c} for c in cats]

    def annotations(self, img_id):
        return self._anns.get(img_id, [])


def _ann(x, y, w, h, cat, crowd=0):
    return {"bbox": [x, y, w, h], "area": w * h, "category_id": cat,
            "iscrowd": crowd}


def _pred(boxes, scores, labels):
    return {"boxes": np.asarray(boxes, dtype=np.float64).reshape(-1, 4),
            "scores": np.asarray(scores, dtype=np.float64),
            "labels": np.asarray(labels, dtype=np.int64)}


def _both(jgt, tgt, preds):
    """(stats, per-category AP) of the JAX and the port's evaluators."""
    out = []
    for mod, gt in ((jce, jgt), (tce, tgt)):
        ev = mod.CocoEvaluator(gt)
        ev.update(preds)
        ev.accumulate()
        out.append((ev.summarize(), ev.per_category_ap()))
    return out


def _assert_same(jgt, tgt, preds):
    (js, jap), (ts, tap) = _both(jgt, tgt, preds)
    assert list(js) == list(ts) == tce.STAT_NAMES
    for k in js:
        assert abs(js[k] - ts[k]) <= TOL, (k, js[k], ts[k])
    assert set(jap) == set(tap)
    for k in jap:
        assert abs(jap[k] - tap[k]) <= TOL, (k, jap[k], tap[k])
    return ts


HAND = {
    "perfect": ({1: [_ann(10, 10, 50, 40, 1)], 2: [_ann(5, 5, 30, 30, 2)]},
                {1: _pred([[10, 10, 60, 50]], [0.9], [1]),
                 2: _pred([[5, 5, 35, 35]], [0.8], [2])}, 1.0),
    "none": ({1: [_ann(10, 10, 50, 40, 1)]},
             {1: _pred(np.zeros((0, 4)), [], [])}, 0.0),
    "half_recall": ({1: [_ann(0, 0, 10, 10, 1), _ann(50, 50, 10, 10, 1)]},
                    {1: _pred([[0, 0, 10, 10]], [0.9], [1])}, 51 / 101),
    "fp_first": ({1: [_ann(0, 0, 10, 10, 1)]},
                 {1: _pred([[0, 0, 10, 10], [80, 80, 90, 90]], [0.8, 0.9],
                           [1, 1])}, 0.5),
    "iou_0.6": ({1: [_ann(0, 0, 10, 10, 1)]},
                {1: _pred([[0, 0, 6, 10]], [0.9], [1])}, 0.3),
    "crowd_ignored": ({1: [_ann(0, 0, 10, 10, 1),
                           _ann(100, 100, 100, 100, 1, crowd=1)]},
                      {1: _pred([[0, 0, 10, 10], [100, 100, 110, 110]],
                                [0.9, 0.8], [1, 1])}, 1.0),
    "area_ranges": ({1: [_ann(100, 100, 50, 50, 1)]},
                    {1: _pred([[100, 100, 150, 150], [0, 0, 9, 9]],
                              [0.8, 0.9], [1, 1])}, 0.5),
    "duplicate": ({1: [_ann(0, 0, 10, 10, 1)]},
                  {1: _pred([[0, 0, 10, 10], [0, 0, 10, 10]], [0.9, 0.8],
                            [1, 1])}, 1.0),
}


@pytest.mark.parametrize("case", list(HAND))
def test_hand_cases_match_jax(case):
    gt, preds, ap = HAND[case]
    index = FakeIndex(gt)
    stats = _assert_same(index, index, preds)
    assert stats["AP"] == pytest.approx(ap, abs=1e-6)


@pytest.fixture(scope="module")
def val_gt():
    return (JIndex(str(JASSETS / "val.json")),
            TIndex(str(TASSETS / "val.json")))


def _gt_boxes(index, iid):
    anns = index.annotations(iid)
    boxes = np.array([[a["bbox"][0], a["bbox"][1],
                       a["bbox"][0] + a["bbox"][2],
                       a["bbox"][1] + a["bbox"][3]] for a in anns],
                     np.float64).reshape(-1, 4)
    return boxes, np.array([a["category_id"] for a in anns], np.int64)


def test_perfect_predictions_on_val(val_gt):
    jgt, tgt = val_gt
    preds = {}
    for iid in tgt.ids:
        boxes, labels = _gt_boxes(tgt, iid)
        preds[iid] = _pred(boxes, np.linspace(0.9, 0.5, len(labels)), labels)
    stats = _assert_same(jgt, tgt, preds)
    assert stats["AP"] == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_predictions_on_val(val_gt, seed):
    """Jittered ground truth with random scores and labels, plus spurious
    boxes, over every val image."""
    jgt, tgt = val_gt
    rng = np.random.default_rng(seed)
    preds = {}
    for iid in tgt.ids:
        boxes, labels = _gt_boxes(tgt, iid)
        wh = boxes[:, 2:] - boxes[:, :2]
        boxes = boxes + rng.normal(0, 0.15, boxes.shape) * np.tile(wh, 2)
        labels = np.where(rng.random(len(labels)) < 0.8, labels,
                          rng.integers(1, 7, len(labels)))
        extra = rng.integers(0, 8)
        xy = rng.uniform(0, 5000, (extra, 2))
        boxes = np.concatenate([boxes, np.concatenate(
            [xy, xy + rng.uniform(20, 200, (extra, 2))], 1)])
        labels = np.concatenate([labels, rng.integers(1, 7, extra)])
        preds[iid] = _pred(boxes, rng.random(len(labels)), labels)
    stats = _assert_same(jgt, tgt, preds)
    assert 0.0 < stats["AP"] < 1.0


def test_empty_categories_and_images(val_gt):
    """Predictions for two categories only, and none at all for a third of
    the images: categories without detections score 0, those without
    ground truth -1, in both evaluators."""
    jgt, tgt = val_gt
    preds = {}
    for n, iid in enumerate(tgt.ids):
        if n % 3 == 0:
            preds[iid] = _pred(np.zeros((0, 4)), [], [])
            continue
        boxes, labels = _gt_boxes(tgt, iid)
        keep = np.isin(labels, (1, 3))
        preds[iid] = _pred(boxes[keep], np.full(keep.sum(), 0.7),
                           labels[keep])
    _assert_same(jgt, tgt, preds)
    (_, jap), (_, tap) = _both(jgt, tgt, preds)
    assert any(v == 0.0 for v in tap.values())
