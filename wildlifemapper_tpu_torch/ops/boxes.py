"""Box utilities (counterpart of wildlifemapper_tpu/ops/boxes.py).

Total functions over leading dims: degenerate boxes give clamped values.
"""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou_pairwise(a: torch.Tensor, b: torch.Tensor):
    """IoU between all pairs. a: (..., N, 4), b: (..., M, 4) xyxy.

    Returns (iou, union), each (..., N, M).
    """
    area_a = box_area(a)
    area_b = box_area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / union.clamp(min=1e-9)
    return iou, union


def generalized_box_iou_pairwise(a: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU (https://giou.stanford.edu/), xyxy inputs: a
    (..., N, 4), b (..., M, 4) -> (..., N, M)."""
    iou, union = box_iou_pairwise(a, b)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=1e-9)


def box_iou_aligned(a: torch.Tensor, b: torch.Tensor):
    """Elementwise IoU of aligned box arrays (..., 4): (iou, union)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou_aligned(a: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of aligned box arrays: the diagonal of the pairwise
    version, computed in O(N)."""
    iou, union = box_iou_aligned(a, b)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=1e-9)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) binary masks -> (N, 4) float32 xyxy bounding boxes, zeros
    for an empty mask (reference box_ops.py:64-87), by masked min / max."""
    _, h, w = masks.shape
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :,
                                                                   None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None,
                                                                   None, :]
    m = masks.to(torch.bool)
    big = 1e9
    x_min = torch.where(m, xs, big).amin(dim=(1, 2))
    y_min = torch.where(m, ys, big).amin(dim=(1, 2))
    x_max = torch.where(m, xs, -big).amax(dim=(1, 2))
    y_max = torch.where(m, ys, -big).amax(dim=(1, 2))
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where(m.any(dim=(1, 2))[:, None], boxes, 0.0)
