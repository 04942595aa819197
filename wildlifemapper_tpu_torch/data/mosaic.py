"""4-image mosaic augmentation (functional, working); a copy of
wildlifemapper_tpu/data/mosaic.py.

Behavioral reference: dataloader_coco.py:98-191 (load_mosaic) + the
random_perspective affine warp (augmentation_yolo.py:107-185). In the
reference the mosaic path is *dead code* — the gate compares image_set
'train' against '_train' (dataloader_coco.py:34) so it never runs; we ship a
working implementation behind DataConfig.use_mosaic (default off for
shipped-behavior parity).

Simplifications vs the YOLO original: the affine warp keeps the reference's
scale/translate jitter but drops the cv2 perspective/shear terms it also
disables (degrees=0, shear=0, perspective=0 at dataloader_coco.py:169-176);
warping is a pure-numpy affine resample (no cv2 in this image).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def box_candidates(before: np.ndarray, after: np.ndarray, wh_thr: float = 2,
                   ar_thr: float = 20, area_thr: float = 0.1) -> np.ndarray:
    """Keep boxes that survive augmentation (augmentation_yolo.py:187-206)."""
    w1, h1 = before[:, 2] - before[:, 0], before[:, 3] - before[:, 1]
    w2, h2 = after[:, 2] - after[:, 0], after[:, 3] - after[:, 1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + 1e-16) > area_thr) & (ar < ar_thr))


def affine_resample(img: np.ndarray, scale: float, tx: float, ty: float,
                    out_size: int, fill: int = 114) -> np.ndarray:
    """Nearest-neighbor affine: out[y, x] = img[(y - ty)/s, (x - tx)/s]."""
    ys = ((np.arange(out_size) - ty) / scale).round().astype(np.int64)
    xs = ((np.arange(out_size) - tx) / scale).round().astype(np.int64)
    valid_y = (ys >= 0) & (ys < img.shape[0])
    valid_x = (xs >= 0) & (xs < img.shape[1])
    out = np.full((out_size, out_size, img.shape[2]), fill, dtype=img.dtype)
    yi = np.clip(ys, 0, img.shape[0] - 1)
    xi = np.clip(xs, 0, img.shape[1] - 1)
    patch = img[yi[:, None], xi[None, :]]
    mask = valid_y[:, None] & valid_x[None, :]
    out[mask] = patch[mask]
    return out


def make_mosaic(images: List[np.ndarray], targets: List[Dict[str, np.ndarray]],
                out_size: int, rng: np.random.Generator,
                scale_jitter: float = 0.9, translate: float = 0.1,
                fill: int = 114) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Compose 4 images around a random center on a 2S x 2S canvas, then
    scale/translate-jitter down to S x S.

    images: 4 HWC uint8 arrays; targets: dicts with 'boxes' (xyxy pixels)
    and 'labels'. Returns (S, S, C) image + merged target.
    """
    assert len(images) == 4 and len(targets) == 4
    s = out_size
    canvas = np.full((2 * s, 2 * s, images[0].shape[2]), fill,
                     dtype=images[0].dtype)
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))

    all_boxes, all_labels = [], []
    for i, (img, tgt) in enumerate(zip(images, targets)):
        h, w = img.shape[:2]
        if i == 0:    # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:         # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
        x2b, y2b = x1b + (x2a - x1a), y1b + (y2a - y1a)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        pad = np.asarray([x1a - x1b, y1a - y1b, x1a - x1b, y1a - y1b],
                         dtype=np.float32)
        if len(tgt["boxes"]):
            all_boxes.append(tgt["boxes"].astype(np.float32) + pad)
            all_labels.append(tgt["labels"])

    if all_boxes:
        boxes = np.clip(np.concatenate(all_boxes), 0, 2 * s)
        labels = np.concatenate(all_labels)
    else:
        boxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int32)

    # scale + translate jitter, output S x S (random_perspective semantics
    # with degrees/shear/perspective = 0 and border = -S/2)
    scale = rng.uniform(1 - scale_jitter, 1 + scale_jitter)
    tx = rng.uniform(0.5 - translate, 0.5 + translate) * s - scale * s
    ty = rng.uniform(0.5 - translate, 0.5 + translate) * s - scale * s
    out = affine_resample(canvas, scale, tx, ty, s, fill)

    if len(boxes):
        before = boxes.copy()
        boxes = boxes * scale + np.asarray([tx, ty, tx, ty], np.float32)
        boxes = np.stack([
            boxes[:, 0].clip(0, s), boxes[:, 1].clip(0, s),
            boxes[:, 2].clip(0, s), boxes[:, 3].clip(0, s)], axis=-1)
        keep = box_candidates(before * scale, boxes)
        boxes, labels = boxes[keep], labels[keep]

    return out, {"boxes": boxes, "labels": labels}
