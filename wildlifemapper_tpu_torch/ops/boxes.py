"""Box utilities (counterpart of wildlifemapper_tpu/ops/boxes.py).

Total functions over leading dims: degenerate boxes give clamped values.
"""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


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
