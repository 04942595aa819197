"""SAM's prompt encoder (point, box and mask embeddings); counterpart of
wildlifemapper_tpu/compat/prompt_encoder.py (reference
segment_anything/modeling/prompt_encoder.py:16-215). WildlifeMapper's
detection path uses only its dense positional encoding
(models/pos_embed.py); this module keeps SAM-style prompting available.

The parameters carry SAM's state-dict names and layouts
(`pe_layer.positional_encoding_gaussian_matrix` a buffer,
`point_embeddings.{0..3}`, `not_a_point_embed`, `no_mask_embed`,
`mask_downscaling.{0,1,3,4,6}`), so a SAM checkpoint's `prompt_encoder.*`
entries load with `load_state_dict` once the prefix is stripped
(`sam_state_dict`); `weights.prompt_encoder_state_dict_from_jax` carries
the JAX module's parameters across.

The interface is the JAX package's: masks NHWC (B, 4H, 4W, 1) in, dense
embeddings (B, H, W, C) out, and `None` for an absent prompt. Inside, the
mask convolutions are nn.Conv2d on a permuted view, as the encoder's neck
runs them, with the port's LayerNorm (eps 1e-6, statistics in float32) and
the exact-erf GELU. Boxes may be (B, 4), as in SAM, or (B, N, 4).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.common import LayerNorm
from ..models.detector import resolve_device

PREFIX = "prompt_encoder."


def _pe_encoding(gauss: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Random-Fourier features of [0, 1]-normalised coords (..., 2)
    (prompt_encoder.py:186-193)."""
    proj = 2.0 * math.pi * ((2.0 * coords - 1.0) @ gauss)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class _PositionEmbeddingRandom(nn.Module):
    """Holds SAM's gaussian matrix under its name (`pe_layer.*`), drawn as
    SAM draws it (prompt_encoder.py:181-184)."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn((2, num_pos_feats)))


class PromptEncoder(nn.Module):
    """Sparse (points and boxes) and dense (mask) prompt embeddings
    (prompt_encoder.py:16-169). Built on the card unless `device` says
    otherwise; parameters are float32, drawn as SAM draws them, and the
    outputs are in `dtype`."""

    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16, dtype: torch.dtype = torch.float32,
                 device: Union[None, str, torch.device] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.dtype = dtype
        with torch.device(resolve_device(device)):
            self.pe_layer = _PositionEmbeddingRandom(embed_dim // 2)
            # negative point, positive point, box top-left, box
            # bottom-right (:45-47), the pad slot (:48), no mask (:60)
            self.point_embeddings = nn.ModuleList(
                nn.Embedding(1, embed_dim) for _ in range(4))
            self.not_a_point_embed = nn.Embedding(1, embed_dim)
            self.no_mask_embed = nn.Embedding(1, embed_dim)
            # 4x spatial reduction to embed_dim (:51-59)
            self.mask_downscaling = nn.Sequential(
                nn.Conv2d(1, mask_in_chans // 4, 2, 2),
                LayerNorm(mask_in_chans // 4), nn.GELU(),
                nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2),
                LayerNorm(mask_in_chans), nn.GELU(),
                nn.Conv2d(mask_in_chans, embed_dim, 1))

    @property
    def mask_input_size(self) -> Tuple[int, int]:
        return (4 * self.image_embedding_size[0],
                4 * self.image_embedding_size[1])

    def _embedding(self, i: int) -> torch.Tensor:
        return self.point_embeddings[i].weight[0]

    def get_dense_pe(self) -> torch.Tensor:
        """(1, H, W, C) dense PE over the embedding grid at pixel centres
        (prompt_encoder.py:62-71, 195-206)."""
        h, w = self.image_embedding_size
        gauss = self.pe_layer.positional_encoding_gaussian_matrix
        ys = (torch.arange(h, dtype=torch.float32, device=gauss.device)
              + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=gauss.device)
              + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([xx, yy], dim=-1)
        return _pe_encoding(gauss, coords)[None].to(self.dtype)

    def _coords(self, points: torch.Tensor) -> torch.Tensor:
        """(..., 2) pixel (x, y) -> [0, 1] of the input image."""
        h, w = self.input_image_size
        return torch.stack([points[..., 0] / w, points[..., 1] / h], dim=-1)

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                      pad: bool) -> torch.Tensor:
        """(B, N, 2) pixel coords and (B, N) labels (1 positive, 0
        negative, -1 pad) -> (B, N[+1], C) (prompt_encoder.py:73-91)."""
        points = points.to(torch.float32) + 0.5       # pixel centres
        if pad:       # the slot that stands in for an absent box (:81-85)
            b = points.shape[0]
            points = torch.cat([points, points.new_zeros((b, 1, 2))], dim=1)
            labels = torch.cat([labels, -labels.new_ones((b, 1))], dim=1)
        pe = _pe_encoding(
            self.pe_layer.positional_encoding_gaussian_matrix,
            self._coords(points))
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        emb = emb + torch.where(lab == 0, self._embedding(0), 0.0)
        emb = emb + torch.where(lab == 1, self._embedding(1), 0.0)
        return emb.to(self.dtype)

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, 4) or (B, N, 4) xyxy pixel boxes -> (B, 2N, C) corner
        embeddings (prompt_encoder.py:93-100; N > 1 generalises SAM's one
        box a batch row)."""
        b = boxes.shape[0]
        corners = (boxes.to(torch.float32) + 0.5).reshape(b, -1, 2)
        pe = _pe_encoding(
            self.pe_layer.positional_encoding_gaussian_matrix,
            self._coords(corners))
        even = (torch.arange(pe.shape[1], device=pe.device) % 2 == 0)
        corner = torch.where(even[None, :, None], self._embedding(2),
                             self._embedding(3))
        return (pe + corner).to(self.dtype)

    def _embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, 4H, 4W, 1) NHWC masks -> (B, H, W, C)
        (prompt_encoder.py:102-105)."""
        conv1, ln1, _, conv2, ln2, _, conv3 = self.mask_downscaling
        dt = self.dtype
        x = masks.to(dt).permute(0, 3, 1, 2)
        for conv, ln in ((conv1, ln1), (conv2, ln2)):
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), stride=2)
            x = F.gelu(ln(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        x = F.conv2d(x, conv3.weight.to(dt), conv3.bias.to(dt))
        return x.permute(0, 2, 3, 1)

    def forward(self, points: Optional[torch.Tensor] = None,
                point_labels: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (sparse (B, N, C), dense (B, H, W, C))
        (prompt_encoder.py:128-169)."""
        given = [t for t in (points, boxes, masks) if t is not None]
        bs = given[0].shape[0] if given else 1
        dev = self.no_mask_embed.weight.device
        sparse = torch.zeros((bs, 0, self.embed_dim), dtype=self.dtype,
                             device=dev)
        if points is not None:
            if point_labels is None:
                raise ValueError("points require point_labels")
            sparse = torch.cat([sparse, self._embed_points(
                points, point_labels, pad=boxes is None)], dim=1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(boxes)], dim=1)
        if masks is not None:
            dense = self._embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
                bs, h, w, self.embed_dim).to(self.dtype)
        return sparse, dense


def sam_state_dict(state_dict: Mapping[str, torch.Tensor]
                   ) -> dict:
    """A SAM checkpoint's `prompt_encoder.*` entries with the prefix
    stripped, for `PromptEncoder.load_state_dict`; a dict without the
    prefix is taken as the prompt encoder's own."""
    if not any(k.startswith(PREFIX) for k in state_dict):
        return dict(state_dict)
    return {k[len(PREFIX):]: v for k, v in state_dict.items()
            if k.startswith(PREFIX)}
