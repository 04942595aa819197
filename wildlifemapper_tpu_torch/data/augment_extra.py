"""Additional photometric/mixing augmentations; a copy of
wildlifemapper_tpu/data/augment_extra.py (numpy only).

Behavioral reference: augmentation_yolo.py — augment_hsv (:33), mixup (:86),
cutout (:59). All are *unused* by the reference's shipped pipeline (only
random_perspective is referenced, from the dead mosaic path); provided here
as working functional ops for completeness. cv2-free: HSV round-trips via
vectorized numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float HSV (h in [0,180) cv2-style, s/v in [0,255])."""
    arr = img.astype(np.float32) / 255.0
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    maxc = arr.max(-1)
    minc = arr.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    h = np.zeros_like(maxc)
    mask = delta > 0
    rc = np.where(mask, (maxc - r) / np.maximum(delta, 1e-12), 0)
    gc = np.where(mask, (maxc - g) / np.maximum(delta, 1e-12), 0)
    bc = np.where(mask, (maxc - b) / np.maximum(delta, 1e-12), 0)
    h = np.where(maxc == r, bc - gc, h)
    h = np.where(maxc == g, 2.0 + rc - bc, h)
    h = np.where(maxc == b, 4.0 + gc - rc, h)
    h = (h / 6.0) % 1.0
    return np.stack([h * 180.0, s * 255.0, v * 255.0], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h = (hsv[..., 0] / 180.0) * 6.0
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2] / 255.0
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return (np.stack([r, g, b], axis=-1) * 255.0).clip(0, 255).astype(np.uint8)


def augment_hsv(img: np.ndarray, rng: np.random.Generator,
                hgain: float = 0.5, sgain: float = 0.5,
                vgain: float = 0.5) -> np.ndarray:
    """Random HSV jitter (augmentation_yolo.py:33-56 semantics)."""
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0] * r[0]) % 180
    hsv[..., 1] = (hsv[..., 1] * r[1]).clip(0, 255)
    hsv[..., 2] = (hsv[..., 2] * r[2]).clip(0, 255)
    return hsv_to_rgb(hsv)


def mixup(img1: np.ndarray, tgt1: Dict, img2: np.ndarray, tgt2: Dict,
          rng: np.random.Generator) -> Tuple[np.ndarray, Dict]:
    """Beta(32, 32) image blend, targets concatenated
    (augmentation_yolo.py:86-104)."""
    lam = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * lam
           + img2.astype(np.float32) * (1 - lam)).astype(img1.dtype)
    tgt = {"boxes": np.concatenate([tgt1["boxes"], tgt2["boxes"]]),
           "labels": np.concatenate([tgt1["labels"], tgt2["labels"]])}
    return img, tgt


def cutout(img: np.ndarray, boxes: np.ndarray,
           rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Random occlusion patches; drops boxes >60% obscured
    (augmentation_yolo.py:59-84)."""
    h, w = img.shape[:2]
    out = img.copy()
    scales = [0.5] + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
    keep = np.ones(len(boxes), dtype=bool)
    for s in scales:
        mh, mw = int(h * s * rng.uniform(0.5, 1)), int(w * s * rng.uniform(0.5, 1))
        y0 = int(rng.uniform(0, h - mh)) if h > mh else 0
        x0 = int(rng.uniform(0, w - mw)) if w > mw else 0
        out[y0:y0 + mh, x0:x0 + mw] = rng.integers(64, 191, 3)
        if len(boxes):
            ix0 = np.maximum(boxes[:, 0], x0)
            iy0 = np.maximum(boxes[:, 1], y0)
            ix1 = np.minimum(boxes[:, 2], x0 + mw)
            iy1 = np.minimum(boxes[:, 3], y0 + mh)
            inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
            area = ((boxes[:, 2] - boxes[:, 0])
                    * (boxes[:, 3] - boxes[:, 1])).clip(1e-9)
            keep &= (inter / area) <= 0.6
    return out, keep
