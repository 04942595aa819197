"""On-device post-processing (counterpart of
wildlifemapper_tpu/eval/postprocess.py): score/label extraction, coordinate
scaling, fixed-shape greedy NMS.

  * PostProcess (build_sam.py:212-258): softmax -> per-query max over the
    real classes -> confidence mask -> cxcywh->xyxy -> scale to the original
    size. `hw_swap_compat` (default) keeps the reference's h/w swap
    (build_sam.py:252).
  * NMS: torchvision.ops.nms(iou=0.4) as the reference's visualisation calls
    it (visualize_prediction.py:150-157), class-agnostic by default.

Every function returns fixed (B, Q) tensors plus a boolean keep mask, and
runs on the tensors' device with no host round trip.
"""

from __future__ import annotations

import torch

from ..ops import boxes as box_ops


def postprocess(outputs, orig_sizes: torch.Tensor,
                confidence_threshold: float = 0.05,
                hw_swap_compat: bool = True):
    """pred_logits (B, Q, L), pred_boxes (B, Q, 4) normalised cxcywh,
    orig_sizes (B, 2) [h, w] -> dict(scores, labels, boxes xyxy, keep)."""
    prob = torch.softmax(outputs["pred_logits"], dim=-1)
    scores, labels = prob[..., :-1].max(dim=-1)
    labels = labels.to(torch.int32)

    boxes = box_ops.box_cxcywh_to_xyxy(outputs["pred_boxes"])
    h = orig_sizes[:, 0].to(boxes.dtype)
    w = orig_sizes[:, 1].to(boxes.dtype)
    if hw_swap_compat:
        # Reference quirk: x scaled by the height and y by the width.
        scale = torch.stack([h, w, h, w], dim=-1)
    else:
        scale = torch.stack([w, h, w, h], dim=-1)
    boxes = boxes * scale[:, None, :]
    keep = scores > confidence_threshold
    return {"scores": scores, "labels": labels, "boxes": boxes, "keep": keep}


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, keep: torch.Tensor,
                iou_threshold: float = 0.4,
                class_aware: bool = False) -> torch.Tensor:
    """Greedy NMS over fixed-size candidate sets, all images at once.

    boxes (B, Q, 4) xyxy, scores (B, Q), labels (B, Q), keep (B, Q) initial
    mask -> surviving mask (B, Q). Q steps of tensor ops: each picks the
    best live candidate per image (first index on ties), keeps it and kills
    what it suppresses.
    """
    b, q = scores.shape
    iou, _ = box_ops.box_iou_pairwise(boxes, boxes)
    suppress = iou > iou_threshold
    if class_aware:
        suppress = suppress & (labels[:, :, None] == labels[:, None, :])
    idx = torch.arange(q, device=scores.device)
    # a Python scalar, not a host tensor: copying one to the device would
    # synchronise the stream
    neg_inf = float("-inf")
    alive = keep.clone()
    out = torch.zeros_like(keep)
    rows = torch.arange(b, device=scores.device)
    for _ in range(q):
        cand = torch.where(alive, scores, neg_inf)
        i = cand.argmax(dim=1)                                  # (B,)
        has = cand[rows, i] > neg_inf                           # (B,)
        out[rows, i] = out[rows, i] | has
        kill = suppress[rows, i] | (idx[None, :] == i[:, None])
        alive = torch.where(has[:, None], alive & ~kill, alive)
    return out
