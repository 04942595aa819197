"""Packed global attention with decomposed rel-pos bias (K2).

Replaces wildlifemapper_tpu/ops/flash_attention_v2.py::
flash_attention_packed (:183) and its two backward kernels (dq/drh/drw :229,
dk/dv :276) in the 4 global ViT-B
blocks (2/5/8/11): qkv (B, N, 3C), N = 4096 on the full canvas or 2304
under either crop. The Pallas kernel kept K and V whole in VMEM with a
single-pass softmax; on the H100 one head's K alone at N = 4096 (512 KB in
bf16) exceeds a block's 227 KB of shared memory, so the kernel
(csrc/attention.cu, shared with K1 and K4) streams keys with an online
softmax. Rel tables are (B, N, H, gh) / (B, N, H, gw).

The backward kernels (csrc/attention_bwd.cu) stream tiles likewise and
recompute p = exp(s - lse) from the lse the forward writes when a gradient
is recorded; delta = rowsum(do * o) is a plain f32 pass, as in `_v2g_bwd`.

On a CPU tensor the wrapper runs the plain version and autograd
differentiates it; on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._attention import attention_plain
from .windowed_attention_v2 import (PackedAttentionFn, _check, _split,
                                    packed_attention_backward_plain)

flash_attention_packed_backward_plain = packed_attention_backward_plain


def flash_attention_packed_plain(qkv, rh, rw, scale: float, num_heads: int,
                                 grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    _check(qkv, rh, rw, num_heads, grid_hw)
    q, k, v = _split(qkv)
    return attention_plain(q, k, v, scale, num_heads, rh, rw)


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
    return PackedAttentionFn.apply(qkv, rh, rw, float(scale), num_heads,
                                   flash_attention_packed)


flash_attention_packed.launches = 0
# backward kernels launched, counted where each is launched: the dq/drh/drw
# kernel and the dk/dv kernel, one of each per backward
# a grid of at most 208 tokens in bf16 takes the one-kernel resident backward
flash_attention_packed.backward_launches = 0
flash_attention_packed.backward_dq_launches = 0
flash_attention_packed.backward_dkv_launches = 0
