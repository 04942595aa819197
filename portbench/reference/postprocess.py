"""The plain reference of the detections: softmax scores over the real
classes, cxcywh -> xyxy in tile pixels, the confidence threshold, and a
greedy class-agnostic NMS (each turn keeps the best live candidate of an
image, lowest index on ties, and drops what overlaps it above the IoU
threshold). The IoU is inter / max(union, 1e-9) in float32."""

from __future__ import annotations

from typing import Dict

import torch

from .criterion import cxcywh_to_xyxy


def detections(out: Dict[str, torch.Tensor], tile: int,
               confidence: float) -> Dict[str, torch.Tensor]:
    prob = torch.softmax(out["pred_logits"].float(), -1)
    scores, labels = prob[..., :-1].max(-1)
    boxes = cxcywh_to_xyxy(out["pred_boxes"].float()) * float(tile)
    return {"scores": scores, "labels": labels, "boxes": boxes,
            "keep": scores > confidence}


def pairwise_iou(a: torch.Tensor) -> torch.Tensor:
    area = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    lt = torch.maximum(a[..., :, None, :2], a[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], a[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, keep: torch.Tensor,
        iou: float) -> torch.Tensor:
    """(B, Q, 4), (B, Q), (B, Q) candidates -> (B, Q) bool survivors."""
    over = pairwise_iou(boxes.float()) > iou
    out = torch.zeros_like(keep, dtype=torch.bool)
    for i in range(scores.shape[0]):
        alive = keep[i].clone()
        s = scores[i]
        while bool(alive.any()):
            j = int(torch.argmax(torch.where(alive, s, float("-inf"))))
            out[i, j] = True
            alive &= ~over[i, j]
            alive[j] = False
    return out
