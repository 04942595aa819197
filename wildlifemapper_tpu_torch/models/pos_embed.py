"""Random-Fourier-feature dense positional encoding (counterpart of
wildlifemapper_tpu/models/pos_embed.py; reference pos_encoder.py:36-70).
The gaussian matrix is a buffer, as in the reference."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..ops._constants import device_constant


@device_constant
def _grid_coords(g: int, device: torch.device) -> torch.Tensor:
    """(g, g, 2) pixel-centre (x, y) coords in [-1, 1] (pos_encoder.py:63-67),
    cached on the device: a host copy per forward would synchronise the
    stream. Built outside inference mode so an autograd caller may use it."""
    coords_1d = (np.arange(g, dtype=np.float32) + 0.5) / g
    yx = np.stack(np.meshgrid(coords_1d, coords_1d, indexing="ij"), -1)
    with torch.inference_mode(False):
        coords = torch.from_numpy(yx[..., ::-1].copy()).to(device)
        return 2.0 * coords - 1.0


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, grid_size: int) -> torch.Tensor:
        """The dense PE grid (grid, grid, 2*num_pos_feats), float32."""
        gauss = self.positional_encoding_gaussian_matrix
        proj = 2.0 * math.pi * (_grid_coords(grid_size, gauss.device) @ gauss)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
