"""Packed windowed attention with decomposed rel-pos bias (K1).

Replaces wildlifemapper_tpu/ops/windowed_attention_v2.py::
windowed_attention_packed (:200) on the forward path of the 8 windowed
ViT-B blocks: qkv (BW, N, 3C) as the qkv GEMM emits it, N = 196 (window 14
on the 64-grid padded to 70, BW = B*25) or 144 (window 12 on the 48-grid,
BW = B*16). The kernel is csrc/attention.cu (shared with K2 and K4); see
its header for what bounds it on the H100 and how the design answers it.
The rel tables are unpadded (BW, N, H, gh) / (BW, N, H, gw): the 16-lane
packing of the Pallas `pack_rel_tables` was a TPU tiling artefact.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._attention import attention_launch, attention_plain


def _split(qkv: torch.Tensor):
    c = qkv.shape[-1] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def _check(qkv, rel_h, rel_w, num_heads, grid_hw):
    gh, gw = grid_hw
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or qkv.shape[1] != gh * gw:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (BW, {gh * gw}, 3C)")
    if rel_h.shape[-1] != gh or rel_w.shape[-1] != gw:
        raise ValueError(f"rel tables {tuple(rel_h.shape)}, "
                         f"{tuple(rel_w.shape)} do not match grid {grid_hw}")


def windowed_attention_packed_plain(qkv, rel_h, rel_w, scale: float,
                                    num_heads: int,
                                    grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    _check(qkv, rel_h, rel_w, num_heads, grid_hw)
    q, k, v = _split(qkv)
    return attention_plain(q, k, v, scale, num_heads, rel_h, rel_w)


class _WindowedAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, scale, num_heads):
        q, k, v = _split(qkv)
        out = attention_launch(q, k, v, scale, num_heads, rel_h, rel_w)
        windowed_attention_packed.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise _build.no_backward("windowed_attention_packed (K1)")


def windowed_attention_packed(qkv, rel_h, rel_w, scale: float,
                              num_heads: int,
                              grid_hw: Tuple[int, int]) -> torch.Tensor:
    """qkv (BW, N, 3C); rel_h (BW, N, H, gh), rel_w (BW, N, H, gw) in qkv's
    dtype; grid_hw = (gh, gw) with gh*gw = N. Returns (BW, N, C)."""
    if qkv.device.type == "cpu":
        return windowed_attention_packed_plain(qkv, rel_h, rel_w, scale,
                                               num_heads, grid_hw)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    _check(qkv, rel_h, rel_w, num_heads, grid_hw)
    return _WindowedAttentionFn.apply(qkv, rel_h, rel_w, float(scale),
                                      num_heads)


windowed_attention_packed.launches = 0
