"""Window partition / unpartition (counterpart of
wildlifemapper_tpu/ops/windows.py; reference image_encoder.py:265-311).

Pad tokens are zeros and are not masked: they take part in attention, as in
SAM.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nWin, window, window, C), zero-padding H/W up to a
    multiple of `window` (64 -> 70 for window 14)."""
    b, h, w, c = x.shape
    pad_h = (-h) % window
    pad_w = (-w) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """Inverse of window_partition; crops away the padding."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // ((hp // window) * (wp // window))
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]
