"""Packed cross-attention of the HFC adaptor (K4).

Replaces wildlifemapper_tpu/ops/cross_attention.py::cross_attention_packed
(:150): bias-free multi-head attention with q (B, N, C) from the patch
stream and k, v (B, M, C) from the HFC stream, C = 1024 = 8 heads x 128,
N = M = 4096 (full canvas and compat crop) or 2304 (crop_prologue). The
kernel is csrc/attention.cu without the bias, at head dim 128 (dynamic
shared memory above 48 KB); see its header for the H100 bound and design.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from ._attention import attention_launch, attention_plain


def cross_attention_packed_plain(q, k, v, scale: float,
                                 num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    return attention_plain(q, k, v, scale, num_heads)


class _CrossAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        out = attention_launch(q, k, v, scale, num_heads)
        cross_attention_packed.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise _build.no_backward("cross_attention_packed (K4)")


def cross_attention_packed(q, k, v, scale: float,
                           num_heads: int) -> torch.Tensor:
    """q (B, N, C) head-packed; k, v (B, M, C). Returns (B, N, C)."""
    if q.device.type == "cpu":
        return cross_attention_packed_plain(q, k, v, scale, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _CrossAttentionFn.apply(q, k, v, float(scale), num_heads)


cross_attention_packed.launches = 0
