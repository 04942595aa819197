"""Automatic-mask-generation utilities of the SAM compat surface; counterpart
of wildlifemapper_tpu/compat/amg.py (reference
segment_anything/utils/amg.py: point grids :60-75, uncompressed RLE
:80-125, stability score :130-145, uncrop helpers :170-198, crop boxes
:200-234).

None of it is on the detection path; a SAM-lineage user expects it beside
the predictor. The point grids, the RLE codecs and the crop boxes are
host-side numpy, as in the JAX package (the port keeps its own copy: it
imports nothing of that package); the stability score, the boxes of masks
and the uncrop helpers are tensor ops that run on the tensors' device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.boxes import masks_to_boxes


# ---- point grids (amg.py:60-75) --------------------------------------------

def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) xy points evenly covering [0,1]^2, half-cell inset."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(coords, coords)
    return np.stack([xs.ravel(), ys.ravel()], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    """One grid per crop layer, scaled down by scale_per_layer each level."""
    return [build_point_grid(max(1, int(n_per_side / (scale_per_layer ** i))))
            for i in range(n_layers + 1)]


# ---- uncompressed RLE (the pycocotools layout) -----------------------------

def mask_to_rle(mask: np.ndarray) -> Dict:
    """(H, W) bool -> {'size': [H, W], 'counts': [...]} uncompressed RLE:
    run lengths in Fortran (column-major) order, always starting with the
    number of leading zeros (possibly 0)."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    elif flat.size == 0:
        counts = [0]
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict) -> np.ndarray:
    """Inverse of mask_to_rle -> (H, W) bool."""
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for count in rle["counts"]:
        flat[pos:pos + count] = val
        pos += count
        val = not val
    return flat.reshape((w, h)).T


def area_from_rle(rle: Dict) -> int:
    return int(sum(rle["counts"][1::2]))


# ---- mask quality and geometry (tensor ops) --------------------------------

def calculate_stability_score(mask_logits: torch.Tensor,
                              mask_threshold: float,
                              threshold_offset: float) -> torch.Tensor:
    """(..., H, W) logits -> (...) float32 IoU between the masks
    thresholded at t + offset and t - offset; 1.0 when both are empty."""
    hi = (mask_logits > (mask_threshold + threshold_offset)).sum(
        dim=(-1, -2)).to(torch.float32)
    lo = (mask_logits > (mask_threshold - threshold_offset)).sum(
        dim=(-1, -2)).to(torch.float32)
    return torch.where(lo > 0, hi / lo.clamp(min=1.0), 1.0)


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., 4) xyxy; zeros for an empty mask."""
    lead = masks.shape[:-2]
    flat = masks.reshape((-1,) + tuple(masks.shape[-2:]))
    return masks_to_boxes(flat).reshape(*lead, 4)


# ---- crop boxes (amg.py:200-234) -------------------------------------------

def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float
                        ) -> Tuple[List[List[int]], List[int]]:
    """Per-layer crop boxes: the full image, then (2**i)^2 overlapping crops
    for layer i. Returns (boxes xyxy, layer indices), in the reference's
    order (x-major, as its itertools.product): layer i has n = 2^i crops a
    side overlapping by int(overlap_ratio * short_side * 2 / n) pixels, a
    crop length the least L with n*L - (n-1)*overlap >= extent, origins
    stepped by L - overlap, boxes clamped to the image."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes: List[List[int]] = [[0, 0, im_w, im_h]]
    layer_idxs: List[int] = [0]

    for layer in range(1, n_layers + 1):
        n = 2 ** layer
        overlap = int(overlap_ratio * short_side * (2.0 / n))
        cw = int(np.ceil((im_w + (n - 1) * overlap) / n))
        ch = int(np.ceil((im_h + (n - 1) * overlap) / n))
        gx, gy = np.meshgrid(np.arange(n) * (cw - overlap),
                             np.arange(n) * (ch - overlap), indexing="ij")
        x0, y0 = gx.ravel(), gy.ravel()
        grid = np.stack([x0, y0, np.minimum(x0 + cw, im_w),
                         np.minimum(y0 + ch, im_h)], axis=1)
        crop_boxes.extend(grid.astype(int).tolist())
        layer_idxs.extend([layer] * (n * n))
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: torch.Tensor,
                      crop_box: List[int]) -> torch.Tensor:
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + torch.tensor([[x0, y0, x0, y0]], dtype=boxes.dtype,
                                device=boxes.device)


def uncrop_points(points: torch.Tensor, crop_box: List[int]) -> torch.Tensor:
    x0, y0 = crop_box[0], crop_box[1]
    return points + torch.tensor([[x0, y0]], dtype=points.dtype,
                                 device=points.device)
