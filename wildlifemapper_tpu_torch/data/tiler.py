"""Sliding-window tiling for large aerial surveys (orthomosaics); a copy
of wildlifemapper_tpu/data/tiler.py (numpy only) whose `extract_tiles` can
also write into a given buffer.

The reference handles scale by tiling images *offline* (dataset dirs named
`coco_1024_fixed`, run.sh) and carries vestigial crop machinery from SAM's
automatic mask generator (utils/amg.py:200-234 crop-box generation,
uncropping). This module is the first-class replacement: deterministic
overlapping tile grids over an arbitrarily large image, batched fixed-shape
tile extraction for the detector, and box uncropping back to mosaic
coordinates (cross-seam fusion happens via global NMS in
eval/orthomosaic.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Overlapping tile layout over an (H, W) image."""

    image_hw: Tuple[int, int]
    tile: int
    stride: int
    origins: Tuple[Tuple[int, int], ...]  # (y0, x0) per tile

    @property
    def num_tiles(self) -> int:
        return len(self.origins)


def make_tile_grid(height: int, width: int, tile: int = 1024,
                   overlap: int = 256) -> TileGrid:
    """Cover the image with tiles of size `tile`, stepping tile-overlap;
    the last tile in each axis is flush with the border (full coverage,
    no partial tiles — mirrors amg.py's crop-box layout)."""
    stride = tile - overlap
    assert stride > 0

    def starts(extent: int) -> List[int]:
        if extent <= tile:
            return [0]
        n = int(np.ceil((extent - tile) / stride)) + 1
        s = [min(i * stride, extent - tile) for i in range(n)]
        return sorted(set(s))

    origins = tuple((y, x) for y in starts(height) for x in starts(width))
    return TileGrid((height, width), tile, stride, origins)


def extract_tiles(image: np.ndarray, grid: TileGrid,
                  indices: Sequence[int] = None,
                  out: np.ndarray = None) -> np.ndarray:
    """(H, W, C) -> (N, tile, tile, C); border tiles zero-padded if the
    image is smaller than one tile. With `indices`, extracts only those
    tiles (streaming callers keep one batch resident at a time). With `out`,
    a buffer of at least N rows (the orthomosaic detector's pinned batch),
    writes there, its rows past the N tiles zero."""
    t = grid.tile
    idxs = range(grid.num_tiles) if indices is None else list(indices)
    if out is None:
        out = np.zeros((len(idxs), t, t, image.shape[2]), image.dtype)
    else:
        out[len(idxs):] = 0
    for row, i in enumerate(idxs):
        y0, x0 = grid.origins[i]
        patch = image[y0:y0 + t, x0:x0 + t]
        ph, pw = patch.shape[:2]
        out[row, :ph, :pw] = patch
        out[row, ph:] = 0
        out[row, :ph, pw:] = 0
    return out


def uncrop_boxes(boxes: np.ndarray, origin: Tuple[int, int]) -> np.ndarray:
    """Tile-local xyxy -> mosaic coordinates (amg.py uncrop semantics)."""
    y0, x0 = origin
    return boxes + np.asarray([x0, y0, x0, y0], dtype=boxes.dtype)


def batched(seq: Sequence, n: int) -> Iterator[list]:
    for i in range(0, len(seq), n):
        yield list(seq[i:i + n])
