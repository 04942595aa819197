"""Synthetic training batches and the two training configurations that the
smoke test and the profile script drive, so that a train step can run with
no dataset: seeded numpy in, the batch dict of train/step.py out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..config import (Config, DataConfig, MatchCriterionConfig, TrainConfig,
                      model_config)

TRAINING_CONFIGS = ("fine_tune", "from_scratch")


def training_config(name: str, dtype: str = "bfloat16",
                    use_kernels: bool = True, batch_size: int = 4,
                    variant: str = "vit_b",
                    remat_blocks: bool = False) -> Config:
    """An encoder (`variant`: vit_b, vit_l or vit_h, at its published
    width and depth) in one of two set-ups. 'fine_tune': full canvas,
    frozen encoder, hfc.dropout 0.1 (the reference's way to train from the
    SAM checkpoint). 'from_scratch': crop_prologue at content 768, window
    12, nothing frozen, hfc.dropout 0 (so the adaptor's attention runs its
    kernel too). `remat_blocks` recomputes each block's activations in the
    backward but its input and attention output (models/vit.py: Block), the
    knob that fits ViT-L / ViT-H training batches in device memory."""
    model = model_config(variant, dtype=dtype, use_flash_attention=use_kernels,
                         remat_blocks=remat_blocks)
    if name == "fine_tune":
        freeze = True
    elif name == "from_scratch":
        freeze = False
        model = dataclasses.replace(
            model, content_size=768, crop_prologue=True,
            vit=dataclasses.replace(model.vit, window_size=12),
            hfc=dataclasses.replace(model.hfc, dropout=0.0,
                                    compat_scrambled_reshape=False))
    else:
        raise ValueError(f"unknown training configuration {name!r}")
    return Config(
        model=model, criterion=MatchCriterionConfig(),
        data=DataConfig(batch_size=batch_size, device_normalize=True,
                        max_targets=MatchCriterionConfig().max_targets),
        train=TrainConfig(freeze_encoder=freeze, use_amp=dtype == "bfloat16"))


def synthetic_batch(batch_size: int, seed: int, canvas: int = 1024,
                    content: int = 768, max_targets: int = 128,
                    min_boxes: int = 5, max_boxes: int = 40
                    ) -> Dict[str, np.ndarray]:
    """A uint8 batch as the loader ships it with device_normalize: random
    content in the top-left `content` pixels of a zero canvas, and between
    min_boxes and max_boxes small boxes an image (cxcywh in canvas units,
    inside the content) with labels 1..6 (the 7 classes less the
    background), padded to max_targets."""
    rng = np.random.default_rng(seed)
    image = np.zeros((batch_size, canvas, canvas, 3), np.uint8)
    image[:, :content, :content] = rng.integers(
        0, 256, size=(batch_size, content, content, 3), dtype=np.uint8)
    labels = np.zeros((batch_size, max_targets), np.int64)
    boxes = np.zeros((batch_size, max_targets, 4), np.float32)
    valid = np.zeros((batch_size, max_targets), bool)
    frac = content / canvas
    for i in range(batch_size):
        n = int(rng.integers(min_boxes, max_boxes + 1))
        wh = rng.uniform(0.01, 0.06, size=(n, 2))
        centre = rng.uniform(wh / 2, frac - wh / 2)
        boxes[i, :n] = np.concatenate([centre, wh], axis=1)
        labels[i, :n] = rng.integers(1, 7, size=n)
        valid[i, :n] = True
    size = np.full((batch_size, 2), content, np.int64)
    return {"image": image, "size": size, "labels": labels, "boxes": boxes,
            "valid": valid}
