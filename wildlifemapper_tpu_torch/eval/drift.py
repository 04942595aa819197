"""Numerical drift measured as mAP, not tensor distance; counterpart of
wildlifemapper_tpu/eval/drift.py.

Serving a model in a cheaper configuration (bf16, the CUDA kernels, the
content-crop tier) perturbs its outputs; what matters for parity is not
activation-level distance but whether the *detections* change. This module
scores one configuration's detections against another's: the trusted
tier's post-NMS detections above `gt_thresh` become pseudo ground truth,
and the candidate tier is evaluated against them with the port's COCOeval
(eval/coco_eval.py) — "drift-as-mAP". AP 1.0 = every detection the
trusted tier keeps is reproduced at matching IoU/score order.
Thresholds of record: pseudo-GT 0.3 (drift harness default) and 0.5 (the
serving threshold, reference visualize_prediction.py:150).
"""
from typing import Dict, Optional

import numpy as np
import torch

from .coco_eval import CocoEvaluator
from .postprocess import postprocess

Dets = Dict[str, np.ndarray]  # boxes (N,Q,4) xyxy, scores (N,Q), labels


class DetsIndex:
    """Minimal CocoIndex-alike over pseudo-GT detections."""

    def __init__(self, anns_by_img: dict, cats):
        self._anns = anns_by_img
        self.categories = [{"id": int(c)} for c in cats]

    def annotations(self, img_id):
        return self._anns.get(img_id, [])


def pseudo_gt_index(gt_dets: Dets, n: int, gt_thresh: float = 0.3
                    ) -> DetsIndex:
    """Trusted-tier detections above `gt_thresh` as a COCO-style GT index."""
    anns, cats = {}, set()
    for i in range(n):
        keep = gt_dets["scores"][i] > gt_thresh
        b = gt_dets["boxes"][i][keep]
        labs = gt_dets["labels"][i][keep]
        anns[i] = [{"bbox": [b[j, 0], b[j, 1], b[j, 2] - b[j, 0],
                             b[j, 3] - b[j, 1]],
                    "area": float((b[j, 2] - b[j, 0]) * (b[j, 3] - b[j, 1])),
                    "category_id": int(labs[j]), "iscrowd": 0}
                   for j in range(len(b))]
        cats |= set(int(lab) for lab in labs)
    return DetsIndex(anns, sorted(cats or {1}))


def drift_summary(gt_dets: Dets, pred_dets: Dets, n: int,
                  gt_thresh: float = 0.3, pred_thresh: float = 0.05) -> dict:
    """COCOeval summary of `pred_dets` scored against `gt_dets`-as-GT.

    Returns the full 12-stat summary dict (keys AP, AP50, AP75, ...)."""
    ev = CocoEvaluator(pseudo_gt_index(gt_dets, n, gt_thresh))
    preds = {}
    for i in range(n):
        k = pred_dets["scores"][i] > pred_thresh
        preds[i] = {"boxes": pred_dets["boxes"][i][k],
                    "scores": pred_dets["scores"][i][k],
                    "labels": pred_dets["labels"][i][k]}
    ev.update(preds)
    ev.accumulate()
    return ev.summarize()


def run_detections(model: torch.nn.Module, tiles: np.ndarray, batch: int,
                   conf: float = 0.05,
                   img_size: Optional[int] = None) -> Dets:
    """Batched forward + postprocess of the port's `model` over `tiles`
    ((N, H, W, 3) normalised f32) on the model's device; pads the tail batch
    with the last tile (fixed shapes) and trims the output."""
    dev = next(model.parameters()).device
    n = len(tiles)
    pad = (-n) % batch
    padded = (np.concatenate([tiles, np.repeat(tiles[-1:], pad, axis=0)])
              if pad else tiles)
    sizes = torch.full((batch, 2), img_size or model.config.img_size,
                       dtype=torch.int32, device=dev)
    outs = []
    with torch.inference_mode():
        for i in range(0, len(padded), batch):
            x = torch.from_numpy(np.ascontiguousarray(
                padded[i:i + batch], np.float32)).to(dev)
            dets = postprocess(model(x), sizes, conf)
            outs.append({k: v.cpu().numpy() for k, v in dets.items()})
    dets = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return {k: v[:n] for k, v in dets.items()}
