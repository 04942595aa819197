"""Interactive predictor; counterpart of
wildlifemapper_tpu/compat/predictor.py (the detection-era analog of the
reference's SamPredictor, predictor.py:269, with ResizeLongestSide).

`set_image` pays for the encoder once and keeps the image embedding;
`predict` runs only the box decoder, the postprocess and the NMS, for
interactive tools that sweep thresholds over one scene. Both run the
port's own WildlifeMapper in halves (`WildlifeMapper.encode` and
`WildlifeMapper.decode`), on the model's device and with the model's
parameters, so `predict` gives what `postprocess(model(canvas))` and the
NMS give on the same canvas in every configuration (the JAX predictor
rebuilds its encoder without the content crop and its decoder without the
PE slice, and agrees with its detector only at the full canvas).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.transforms import (normalize_image, pad_to_canvas,
                               resize_keep_aspect, resize_uint8)
from ..eval.postprocess import batched_nms, postprocess


class WildlifeMapperPredictor:
    def __init__(self, model):
        """`model`: a wildlifemapper_tpu_torch WildlifeMapper, on the card
        or on the CPU; the predictor runs where it lives."""
        self.model = model
        self.cfg = model.config
        self._embedding: Optional[torch.Tensor] = None
        self._orig_hw: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def preprocess(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 RGB -> the (1, S, S, 3) float32 canvas on the
        model's device, as the train pipeline makes it: the longer side
        resized to the content extent (the configured content_size, else
        the pipeline's 768-in-1024 ratio) by antialiased bilinear
        (`data/transforms.py::resize_uint8`, PIL's BILINEAR within one
        level), normalised, zero-padded to the canvas."""
        h0, w0 = image.shape[:2]
        target = self.cfg.content_size or int(self.cfg.img_size * 768 / 1024)
        ow, oh = resize_keep_aspect((w0, h0), target, target)
        resized = (image if (ow, oh) == (w0, h0)
                   else resize_uint8(image, ow, oh))
        canvas = pad_to_canvas(normalize_image(resized), self.cfg.img_size)
        return torch.from_numpy(canvas[None]).to(self.device)

    @torch.inference_mode()
    def set_image(self, image: np.ndarray):
        """image: (H, W, 3) uint8 RGB. Resizes and pads it as the train
        pipeline does and keeps the image embedding."""
        self._embedding = self.model.encode(self.preprocess(image))
        self._orig_hw = (int(image.shape[0]), int(image.shape[1]))

    @property
    def is_image_set(self) -> bool:
        return self._embedding is not None

    def get_image_embedding(self) -> torch.Tensor:
        """(1, g, g, out_chans) in the compute dtype, on the model's
        device."""
        if not self.is_image_set:
            raise RuntimeError("call set_image first")
        return self._embedding

    @torch.inference_mode()
    def predict(self, score_threshold: float = 0.5, nms_iou: float = 0.4,
                apply_nms: bool = True) -> Dict[str, np.ndarray]:
        """Detections in the original image's pixels: boxes (K, 4) xyxy,
        scores (K,), labels (K,), as numpy arrays."""
        if not self.is_image_set:
            raise RuntimeError("call set_image first")
        out = self.model.decode(self._embedding)
        sizes = torch.tensor([self._orig_hw]).to(self.device)
        dets = postprocess(out, sizes, score_threshold, hw_swap_compat=False)
        if apply_nms:
            dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                       dets["labels"], dets["keep"], nms_iou,
                                       class_aware=False)
        keep = dets["keep"][0]
        return {k: dets[k][0][keep].cpu().numpy()
                for k in ("boxes", "scores", "labels")}

    def reset_image(self):
        self._embedding = None
        self._orig_hw = None
