"""On-device AP@0.5 proxy for in-loop logging; counterpart of
wildlifemapper_tpu/eval/fast_ap.py.

The full COCO evaluator (coco_eval.py) is host-side and ragged; this is a
fixed-shape approximation for cheap per-epoch curves: greedy score-ordered
matching at IoU 0.5 per image, batch-pooled 101-point interpolated
precision. Tracks the real AP50 closely but is NOT the COCO number — use
CocoEvaluator for reporting. Tensor ops on the inputs' device; the greedy
match runs as Q steps over the whole batch at once (as
postprocess.batched_nms does), and nothing waits for the device.
"""

from __future__ import annotations

import torch

from ..ops import boxes as box_ops

IOU_THR = 0.5


def fast_ap50(det_boxes, det_scores, det_labels, det_keep,
              gt_boxes, gt_labels, gt_valid) -> torch.Tensor:
    """All inputs fixed-shape: det_* (B, Q[, 4]), gt_* (B, T[, 4]) with
    boxes in the same (xyxy) coordinate frame. Returns the AP50 proxy as a
    0-d float32 tensor on the inputs' device."""
    b, q = det_scores.shape
    dev = det_scores.device
    neg_inf = float("-inf")

    iou, _ = box_ops.box_iou_pairwise(det_boxes, gt_boxes)      # (B, Q, T)
    cls_ok = det_labels[:, :, None] == gt_labels[:, None, :]
    cand = torch.where(cls_ok & gt_valid[:, None, :], iou, 0.0)

    order = torch.argsort(-torch.where(det_keep, det_scores, neg_inf), dim=1,
                          stable=True)
    rows = torch.arange(b, device=dev)
    gt_used = torch.zeros_like(gt_valid, dtype=torch.bool)
    tp = torch.zeros_like(det_keep, dtype=torch.bool)
    for j in range(q):
        d = order[:, j]                                          # (B,)
        ious_d = torch.where(gt_used, 0.0, cand[rows, d])        # (B, T)
        g = ious_d.argmax(dim=1)                                 # (B,)
        ok = (ious_d[rows, g] >= IOU_THR) & det_keep[rows, d]
        gt_used[rows, g] = gt_used[rows, g] | ok
        tp[rows, d] = ok

    scores_flat = torch.where(det_keep, det_scores, neg_inf).reshape(-1)
    order_flat = torch.argsort(-scores_flat, stable=True)
    tp_sorted = tp.reshape(-1)[order_flat].to(torch.float32)
    valid_sorted = det_keep.reshape(-1)[order_flat].to(torch.float32)

    ctp = torch.cumsum(tp_sorted, 0)
    cfp = torch.cumsum(valid_sorted * (1.0 - tp_sorted), 0)
    npos = gt_valid.to(torch.float32).sum().clamp(min=1.0)
    recall = ctp / npos
    precision = ctp / (ctp + cfp).clamp(min=1e-9)

    # monotone precision envelope from the right
    precision = precision.flip(0).cummax(0).values.flip(0)
    # 0, 0.01, ..., 1 as jnp.linspace(0, 1, 101) rounds them in float32
    rec_thrs = torch.arange(101, dtype=torch.float32, device=dev) * 0.01
    rec_thrs[-1] = 1.0
    idx = torch.searchsorted(recall, rec_thrs)
    n = recall.shape[0]
    prec_at = torch.where(idx < n, precision[idx.clamp(max=n - 1)], 0.0)
    return prec_at.mean()
