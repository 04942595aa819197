"""COCO-style detection evaluation (the standard 12-stat bbox suite),
implemented from the COCOeval specification in pure numpy; a copy of
wildlifemapper_tpu/eval/coco_eval.py. It matches through the port's
native.coco_match (C++, built at first use) where that library builds, else
with the numpy `match_greedy`; the two give equal stats
(tests/test_torch_eval_tools.py).

The reference evaluates with pycocotools' C extension
(inference.py:15-17, 92-128, 278-323); that package is not in this image, so
this module reimplements the published algorithm: greedy score-ordered
matching per (image, category) at IoU thresholds 0.5:0.05:0.95, crowd/ignore
semantics, area-range splits, maxDets {1, 10, 100}, 101-point interpolated
precision.

Host-side by design: mAP is a ragged, sort-heavy computation that runs once
per epoch on a handful of images; the hot path (IoU matrices) is vectorized
numpy.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNGS = {
    "all": (0.0, 1e5 ** 2),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e5 ** 2),
}
STAT_NAMES = [
    "AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
    "AR1", "AR10", "AR100", "AR_small", "AR_medium", "AR_large",
]


def iou_xyxy(dts: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix (D, G); crowd GTs use intersection/dt_area."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    lt = np.maximum(dts[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dts[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dts[:, 2] - dts[:, 0]) * (dts[:, 3] - dts[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    denom = np.where(iscrowd[None, :], area_d[:, None], union)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def match_greedy(ious: np.ndarray, thrs: np.ndarray, g_ignore: np.ndarray,
                 gcrowd: np.ndarray):
    """Pure-python COCOeval greedy matcher (the exact published semantics:
    score-ordered dts, each takes the best still-free GT above thr; crowd
    GTs are reusable; once a non-ignored match exists, ignored GTs cannot
    displace it). Returns (dtm (T,D) 1-based, dt_ig (T,D),
    gtm (T,G) 1-based)."""
    T, D, G = len(thrs), ious.shape[0], ious.shape[1]
    dtm = np.zeros((T, D), dtype=np.int64)
    gtm = np.zeros((T, G), dtype=np.int64)
    dt_ig = np.zeros((T, D), dtype=bool)
    for ti, thr in enumerate(thrs):
        for d in range(D):
            best_iou = min(thr, 1 - 1e-10)
            m = -1
            for g in range(G):
                if gtm[ti, g] > 0 and not gcrowd[g]:
                    continue
                if m > -1 and not g_ignore[m] and g_ignore[g]:
                    break  # ran past all non-ignored candidates
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                m = g
            if m == -1:
                continue
            dt_ig[ti, d] = g_ignore[m]
            dtm[ti, d] = m + 1
            gtm[ti, m] = d + 1
    return dtm, dt_ig, gtm


class CocoEvaluator:
    """Accumulates per-image detections and computes the 12 COCO stats.

    Ground truth comes from a CocoIndex (data/coco.py). Detections are fed
    via update() as {image_id: {"scores", "labels", "boxes" (xyxy abs)}},
    mirroring the reference's CocoEvaluator.update (inference.py:106-123).
    """

    def __init__(self, gt_index, cat_ids: Sequence[int] = ()):
        self.gt = gt_index
        self.cat_ids = list(cat_ids) or [c["id"] for c in gt_index.categories]
        self.img_ids: List[int] = []
        self._dts: Dict[int, dict] = {}

    def update(self, predictions: Dict[int, dict]):
        for img_id, pred in predictions.items():
            if img_id in self._dts:
                continue
            self.img_ids.append(img_id)
            self._dts[img_id] = {
                "scores": np.asarray(pred["scores"], dtype=np.float64),
                "labels": np.asarray(pred["labels"], dtype=np.int64),
                "boxes": np.asarray(pred["boxes"], dtype=np.float64).reshape(-1, 4),
            }

    # ---- core evaluation -------------------------------------------------

    def _gt_for(self, img_id: int, cat_id: int):
        anns = [a for a in self.gt.annotations(img_id)
                if a["category_id"] == cat_id]
        boxes = np.asarray([[a["bbox"][0], a["bbox"][1],
                             a["bbox"][0] + a["bbox"][2],
                             a["bbox"][1] + a["bbox"][3]] for a in anns],
                           dtype=np.float64).reshape(-1, 4)
        areas = np.asarray([a.get("area",
                                  a["bbox"][2] * a["bbox"][3]) for a in anns],
                           dtype=np.float64)
        iscrowd = np.asarray([a.get("iscrowd", 0) for a in anns], dtype=bool)
        return boxes, areas, iscrowd

    def _img_cat(self, img_id: int, cat_id: int):
        """Area-independent work for one (image, category): parsed GT,
        score-sorted top-maxDets[-1] detections, and the IoU matrix —
        pycocotools computes these once and reuses them across all area
        ranges and maxDets (computeIoU is keyed (img, cat) only)."""
        gboxes, gareas, gcrowd = self._gt_for(img_id, cat_id)
        dt = self._dts[img_id]
        sel = dt["labels"] == cat_id
        dscores, dboxes = dt["scores"][sel], dt["boxes"][sel]
        if len(gboxes) == 0 and len(dscores) == 0:
            return None
        dt_order = np.argsort(-dscores, kind="mergesort")[:MAX_DETS[-1]]
        dscores, dboxes = dscores[dt_order], dboxes[dt_order]
        dareas = (dboxes[:, 2] - dboxes[:, 0]) * (dboxes[:, 3] - dboxes[:, 1])
        return {
            "gareas": gareas, "gcrowd": gcrowd,
            "scores": dscores, "dareas": dareas,
            "ious": iou_xyxy(dboxes, gboxes, gcrowd),
        }

    def _evaluate_img(self, img_id: int, cat_id: int, area_rng,
                      max_det: int, _cache=None):
        """One (image, category, area) evaluation at `max_det` detections.

        Greedy matching is prefix-stable in det-score order (dt d's match
        depends only on higher-scored dts), so matching once at
        maxDets[-1] and slicing columns for smaller maxDets is exactly
        pycocotools' accumulate()-side slicing."""
        e = _cache if _cache is not None else self._img_cat(img_id, cat_id)
        if e is None:
            return None
        gareas, gcrowd = e["gareas"], e["gcrowd"]
        dscores, dareas = e["scores"], e["dareas"]

        g_ignore = gcrowd | (gareas < area_rng[0]) | (gareas > area_rng[1])
        gt_order = np.argsort(g_ignore, kind="mergesort")  # non-ignored first
        gcrowd, g_ignore = gcrowd[gt_order], g_ignore[gt_order]
        ious = e["ious"][:, gt_order]

        native_result = None
        if len(dscores) and ious.shape[1]:
            from .. import native
            native_result = native.coco_match(ious, IOU_THRS, g_ignore, gcrowd)
        if native_result is not None:
            dtm, dt_ig, gtm = native_result
        else:
            dtm, dt_ig, gtm = match_greedy(ious, IOU_THRS, g_ignore, gcrowd)
        out_of_rng = (dareas < area_rng[0]) | (dareas > area_rng[1])
        dt_ig = dt_ig | ((dtm == 0) & out_of_rng[None, :])
        return {
            "scores": dscores[:max_det], "dtm": dtm[:, :max_det],
            "dt_ig": dt_ig[:, :max_det], "g_ignore": g_ignore,
        }

    def accumulate(self):
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNGS), len(MAX_DETS)
        self.precision = -np.ones((T, R, K, A, M))
        self.recall = -np.ones((T, K, A, M))
        area_items = list(AREA_RNGS.values())
        max_det_last = MAX_DETS[-1]
        for ki, cat in enumerate(self.cat_ids):
            caches = {i: self._img_cat(i, cat) for i in self.img_ids}
            for ai, rng in enumerate(area_items):
                # match once per (img, area) at the largest maxDet; smaller
                # maxDets slice the det columns (prefix-stable, see
                # _evaluate_img docstring)
                full = [self._evaluate_img(i, cat, rng, max_det_last,
                                           _cache=caches[i])
                        for i in self.img_ids]
                full = [e for e in full if e is not None]
                for mi, max_det in enumerate(MAX_DETS):
                    evs = [{"scores": e["scores"][:max_det],
                            "dtm": e["dtm"][:, :max_det],
                            "dt_ig": e["dt_ig"][:, :max_det],
                            "g_ignore": e["g_ignore"]} for e in full]
                    if not evs:
                        continue
                    scores = np.concatenate([e["scores"] for e in evs])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dtm"] for e in evs], axis=1)[:, order]
                    dt_ig = np.concatenate([e["dt_ig"] for e in evs], axis=1)[:, order]
                    npig = int(sum((~e["g_ignore"]).sum() for e in evs))
                    if npig == 0:
                        continue
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
                    fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        self.recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                        # precision envelope (monotone from the right)
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        self.precision[ti, :, ki, ai, mi] = q

    def summarize(self) -> Dict[str, float]:
        def ap(iou=None, area="all", max_det=100):
            ai = list(AREA_RNGS).index(area)
            mi = MAX_DETS.index(max_det)
            p = self.precision[:, :, :, ai, mi]
            if iou is not None:
                ti = int(np.argmin(np.abs(IOU_THRS - iou)))
                p = p[ti:ti + 1]
            valid = p[p > -1]
            return float(valid.mean()) if valid.size else -1.0

        def ar(area="all", max_det=100):
            ai = list(AREA_RNGS).index(area)
            mi = MAX_DETS.index(max_det)
            r = self.recall[:, :, ai, mi]
            valid = r[r > -1]
            return float(valid.mean()) if valid.size else -1.0

        stats = [
            ap(), ap(iou=0.5), ap(iou=0.75),
            ap(area="small"), ap(area="medium"), ap(area="large"),
            ar(max_det=1), ar(max_det=10), ar(max_det=100),
            ar(area="small"), ar(area="medium"), ar(area="large"),
        ]
        self.stats = dict(zip(STAT_NAMES, stats))
        return self.stats

    def per_category_ap(self) -> Dict[int, float]:
        """AP (IoU .5:.95, all areas, maxDets 100) per category id — finer
        reporting than the reference's 12 aggregate stats (useful for the
        per-species breakdown the paper discusses)."""
        ai = list(AREA_RNGS).index("all")
        mi = MAX_DETS.index(100)
        out = {}
        for ki, cat in enumerate(self.cat_ids):
            p = self.precision[:, :, ki, ai, mi]
            valid = p[p > -1]
            out[cat] = float(valid.mean()) if valid.size else -1.0
        return out

    def print_summary(self):
        labels = [
            ("Average Precision", "(AP)", "0.50:0.95", "all", 100),
            ("Average Precision", "(AP)", "0.50", "all", 100),
            ("Average Precision", "(AP)", "0.75", "all", 100),
            ("Average Precision", "(AP)", "0.50:0.95", "small", 100),
            ("Average Precision", "(AP)", "0.50:0.95", "medium", 100),
            ("Average Precision", "(AP)", "0.50:0.95", "large", 100),
            ("Average Recall", "(AR)", "0.50:0.95", "all", 1),
            ("Average Recall", "(AR)", "0.50:0.95", "all", 10),
            ("Average Recall", "(AR)", "0.50:0.95", "all", 100),
            ("Average Recall", "(AR)", "0.50:0.95", "small", 100),
            ("Average Recall", "(AR)", "0.50:0.95", "medium", 100),
            ("Average Recall", "(AR)", "0.50:0.95", "large", 100),
        ]
        for (title, typ, iou, area, md), (name, v) in zip(labels,
                                                          self.stats.items()):
            print(f" {title:<18} {typ} @[ IoU={iou:<9} | area={area:>6} | "
                  f"maxDets={md:>3} ] = {v:0.3f}")
