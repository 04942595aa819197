"""Packed global attention with decomposed rel-pos bias (K2).

Replaces wildlifemapper_tpu/ops/flash_attention_v2.py::
flash_attention_packed (:183) on the forward path of the 4 global ViT-B
blocks (2/5/8/11): qkv (B, N, 3C), N = 4096 on the full canvas or 2304
under either crop. The Pallas kernel kept K and V whole in VMEM with a
single-pass softmax; on the H100 one head's K alone at N = 4096 (512 KB in
bf16) exceeds a block's 227 KB of shared memory, so the kernel
(csrc/attention.cu, shared with K1 and K4) streams keys with an online
softmax. Rel tables are (B, N, H, gh) / (B, N, H, gw).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._attention import attention_launch, attention_plain
from .windowed_attention_v2 import _check, _split


def flash_attention_packed_plain(qkv, rh, rw, scale: float, num_heads: int,
                                 grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    _check(qkv, rh, rw, num_heads, grid_hw)
    q, k, v = _split(qkv)
    return attention_plain(q, k, v, scale, num_heads, rh, rw)


class _FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, rh, rw, scale, num_heads):
        q, k, v = _split(qkv)
        out = attention_launch(q, k, v, scale, num_heads, rh, rw)
        flash_attention_packed.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise _build.no_backward("flash_attention_packed (K2)")


def flash_attention_packed(qkv, rh, rw, scale: float, num_heads: int,
                           grid_hw: Tuple[int, int]) -> torch.Tensor:
    """qkv (B, N, 3C); rh (B, N, H, gh), rw (B, N, H, gw) in qkv's dtype;
    grid_hw = (gh, gw) with gh*gw = N. Returns (B, N, C)."""
    if qkv.device.type == "cpu":
        return flash_attention_packed_plain(qkv, rh, rw, scale, num_heads,
                                            grid_hw)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    _check(qkv, rh, rw, num_heads, grid_hw)
    return _FlashAttentionFn.apply(qkv, rh, rw, float(scale), num_heads)


flash_attention_packed.launches = 0
