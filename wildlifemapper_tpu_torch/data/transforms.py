"""Host-side preprocessing with fixed-shape outputs; counterpart of
wildlifemapper_tpu/data/transforms.py, in numpy, with no PIL at import.

Behavioral parity targets:
  * ConvertCocoPolysToMask (dataloader_coco.py:210-272): drop crowd anns,
    xywh -> xyxy with clamping, keep positive-area boxes, carry orig_size.
  * RandomResize([768], max_size=768) (augmentation.py:77-133): shorter side
    to 768 unless the longer side would exceed 768. The JAX package resizes
    with PIL's bilinear filter; here it is torch's bilinear interpolation
    with antialiasing on the CPU, which gives PIL's pixels bit for bit at a
    3/4 shrink (1024 -> 768, 256 -> 192, 64 -> 48) and at an enlargement
    (256 -> 768), and within one level elsewhere (the original
    5472 x 3648 frames). PIL is imported only to decode a real image file.
  * ToTensor + Normalize (augmentation.py:229-263): /255, ImageNet
    mean/std, boxes -> normalized cxcywh w.r.t. the *resized* (pre-pad) size.
  * FlipLR (augmentation.py:265-285): a VERTICAL flip with cy -> 1-cy,
    replicated when `flip_is_vertical=True`.
  * custom_collate / NestedTensor (misc.py:46-84): zero-pad to the fixed
    canvas, content in the top-left corner.

Targets are padded to `max_targets` with a validity mask, so every step
takes static shapes.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def target_from_annotations(anns, width: int, height: int) -> Dict[str, np.ndarray]:
    """COCO annotations -> xyxy boxes + labels (dataloader_coco.py:214-272)."""
    anns = [a for a in anns if a.get("iscrowd", 0) == 0]
    if anns:
        boxes = np.asarray([a["bbox"] for a in anns], dtype=np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, width)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, height)
        labels = np.asarray([a["category_id"] for a in anns], dtype=np.int32)
        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        boxes, labels = boxes[keep], labels[keep]
    else:
        boxes = np.zeros((0, 4), dtype=np.float32)
        labels = np.zeros((0,), dtype=np.int32)
    return {"boxes": boxes, "labels": labels,
            "orig_size": np.asarray([height, width], dtype=np.int32)}


def resize_keep_aspect(size: Tuple[int, int], target: int,
                       max_size: Optional[int]) -> Tuple[int, int]:
    """(w, h) -> output (w, h); shorter side to `target`, capped so the
    longer side stays <= max_size (augmentation.py:80-98)."""
    w, h = size
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * target > max_size:
            target = int(round(max_size * mn / mx))
    if (w <= h and w == target) or (h <= w and h == target):
        return (w, h)
    if w < h:
        return (target, int(target * h / w))
    return (int(target * w / h), target)


def resize_uint8(img: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """Bilinear resize of a uint8 HWC array to (oh, ow) with antialiasing
    (PIL's BILINEAR filter), through torch on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t.contiguous(memory_format=torch.channels_last),
                        size=(oh, ow), mode="bilinear", antialias=True,
                        align_corners=False)
    return np.ascontiguousarray(out[0].permute(1, 2, 0).numpy())


def resize_image_and_boxes(img: np.ndarray, boxes: np.ndarray,
                           target: int, max_size: Optional[int]):
    """uint8 (H, W, 3) image + xyxy pixel boxes -> the resized pair and the
    resized (h, w). At the input's own size the image is returned as it is,
    as PIL's resize to the same size returns its input's pixels."""
    h, w = img.shape[:2]
    ow, oh = resize_keep_aspect((w, h), target, max_size)
    resized = img if (ow, oh) == (w, h) else resize_uint8(img, ow, oh)
    rw, rh = ow / w, oh / h
    boxes = boxes * np.asarray([rw, rh, rw, rh], dtype=np.float32)
    return resized, boxes, (oh, ow)


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 normalized."""
    return ((arr.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def boxes_to_normalized_cxcywh(boxes: np.ndarray, size_hw) -> np.ndarray:
    """xyxy pixels -> cxcywh normalized by the post-resize size
    (augmentation.py:258-262)."""
    h, w = size_hw
    if len(boxes) == 0:
        return boxes.reshape(0, 4)
    cxcywh = np.stack([
        (boxes[:, 0] + boxes[:, 2]) * 0.5, (boxes[:, 1] + boxes[:, 3]) * 0.5,
        boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]], axis=-1)
    return (cxcywh / np.asarray([w, h, w, h], dtype=np.float32)).astype(np.float32)


def flip(image: np.ndarray, boxes: np.ndarray, vertical: bool):
    """Flip an HWC image + normalized cxcywh boxes.

    vertical=True replicates the reference's FlipLR quirk (flips H, updates
    cy); vertical=False is a genuine horizontal flip (flips W, updates cx).
    """
    if vertical:
        image = image[::-1, :, :]
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 1] = 1.0 - boxes[:, 1]
    else:
        image = image[:, ::-1, :]
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 0] = 1.0 - boxes[:, 0]
    return np.ascontiguousarray(image), boxes


def pad_to_canvas(image: np.ndarray, canvas: int) -> np.ndarray:
    """Zero-pad HWC content into the top-left of a (canvas, canvas) frame
    (misc.py:46-67; content is the 768-resized image in a 1024 canvas)."""
    h, w, c = image.shape
    out = np.zeros((canvas, canvas, c), dtype=image.dtype)
    out[:h, :w] = image
    return out


def pad_targets(boxes: np.ndarray, labels: np.ndarray, max_targets: int,
                allow_truncate: bool = False):
    """Ragged targets -> fixed (max_targets,) arrays + validity mask.

    Overflow is an ERROR by default: the reference trains on ragged,
    untruncated targets (dataloader_coco.py:253-270), so dropping GT here
    would silently deflate recall. `DataConfig.max_targets=None` (the
    default) sizes the cap from the annotation file so overflow cannot
    happen; tiny test harnesses that deliberately undersize the cap opt in
    with `allow_truncate=True` (truncates WITH a warning). Padding slots
    get label 0 / centered dummy boxes.
    """
    if len(labels) > max_targets:
        if not allow_truncate:
            raise ValueError(
                f"pad_targets: {len(labels)} targets exceed "
                f"max_targets={max_targets} and truncation would silently "
                "drop ground truth. Leave DataConfig.max_targets=None to "
                "size it from the annotation file, raise it explicitly, or "
                "set allow_truncation=True to accept lossy truncation.")
        warnings.warn(
            f"pad_targets: truncating {len(labels)} targets to "
            f"max_targets={max_targets}; raise criterion.max_targets / "
            f"data.max_targets to keep them all", RuntimeWarning,
            stacklevel=2)
    n = min(len(labels), max_targets)
    out_boxes = np.full((max_targets, 4), 0.5, dtype=np.float32)
    out_labels = np.zeros((max_targets,), dtype=np.int32)
    valid = np.zeros((max_targets,), dtype=bool)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = labels[:n]
    valid[:n] = True
    return out_boxes, out_labels, valid


@dataclasses.dataclass
class PreprocessConfig:
    resize_size: int = 768
    canvas_size: int = 1024
    # None -> sized from the annotation file at dataset construction
    # (CocoDetectionDataset.__init__), so no GT is ever dropped.
    max_targets: Optional[int] = 128
    # Opt-in lossy truncation for deliberately undersized caps (tiny test
    # harnesses). Never set this for real training.
    allow_truncation: bool = False
    flip_prob: float = 0.0
    flip_is_vertical: bool = True
    use_mosaic: bool = False
    # Emit uint8 canvases and normalize on the device (train/step.py):
    # 4x less host-to-device traffic, the same f32 math.
    emit_uint8: bool = False


def finish_example(arr_u8: np.ndarray, boxes_xyxy: np.ndarray,
                   labels: np.ndarray, image_id: int, orig_size: np.ndarray,
                   size_hw, cfg: PreprocessConfig,
                   rng: Optional[np.random.Generator] = None
                   ) -> Dict[str, np.ndarray]:
    """Shared tail of the pipeline: normalize, box-normalize, flip, pad."""
    arr = arr_u8 if cfg.emit_uint8 else normalize_image(arr_u8)
    boxes = boxes_to_normalized_cxcywh(boxes_xyxy, size_hw)
    if cfg.flip_prob > 0 and rng is not None and rng.random() < cfg.flip_prob:
        arr, boxes = flip(arr, boxes, cfg.flip_is_vertical)
    arr = pad_to_canvas(arr, cfg.canvas_size)
    pboxes, plabels, valid = pad_targets(boxes, labels, cfg.max_targets,
                                         cfg.allow_truncation)
    return {
        "image": arr,
        "boxes": pboxes,
        "labels": plabels,
        "valid": valid,
        "image_id": np.asarray(image_id, dtype=np.int64),
        "orig_size": np.asarray(orig_size, dtype=np.int32),
        "size": np.asarray(size_hw, dtype=np.int32),
    }


def decode_image(path: Union[str, Path]) -> np.ndarray:
    """A real image file -> uint8 (H, W, 3) RGB. PIL is imported here, and
    only here: synthetic data needs no PIL."""
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img.convert("RGB"), dtype=np.uint8)


def preprocess_example(img: Union[str, Path, np.ndarray], anns,
                       image_id: int, cfg: PreprocessConfig,
                       rng: Optional[np.random.Generator] = None
                       ) -> Dict[str, np.ndarray]:
    """Full per-example host pipeline -> fixed-shape numpy dict. `img` is
    an image file (decoded with PIL) or a uint8 (H, W, 3) array."""
    arr = img if isinstance(img, np.ndarray) else decode_image(img)
    h, w = arr.shape[:2]
    tgt = target_from_annotations(anns, w, h)
    resized, boxes_xyxy, size_hw = resize_image_and_boxes(
        arr, tgt["boxes"], cfg.resize_size, cfg.resize_size)
    return finish_example(resized, boxes_xyxy, tgt["labels"], image_id,
                          tgt["orig_size"], size_hw, cfg, rng)
