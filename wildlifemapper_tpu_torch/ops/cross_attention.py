"""Packed cross-attention of the HFC adaptor (K4).

Replaces wildlifemapper_tpu/ops/cross_attention.py::cross_attention_packed
(:150) and its two backward kernels (dq :90, dk/dv :116): bias-free multi-head attention with q (B, N, C) from the patch
stream and k, v (B, M, C) from the HFC stream, C = 1024 = 8 heads x 128,
N = M = 4096 (full canvas and compat crop) or 2304 (crop_prologue). The
kernel is csrc/attention.cu without the bias, at head dim 128: in bf16 the
Hopper body (csrc/attention_sm90.cu) from 512 keys, in f32 from 512 keys
the register-tiled f32 body (csrc/attention_fwd_f32.cu), else the tile body
(csrc/attention_fwd.cuh); each body's header says what bounds it on the
H100.

The backward kernels run on the lse the forward writes when a gradient is
recorded, without rel tables: in bf16 the Hopper backward's dq kernel
(delta inside) and dk/dv kernel, in f32 from 512 keys the d-128 f32 body's
delta and dk/dv kernels (counted as the dk/dv launch) and its dq kernel
(csrc/attention_bwd_f32_d128.cu), else the tile body's (csrc/attention_bwd.cu).

On a CPU tensor the wrapper runs the plain version and autograd
differentiates it; on a CUDA tensor it launches the kernels or raises,
the forward through its operator (ops/_library.py).
"""

from __future__ import annotations

import torch

from ._attention import (attention_backward_launch,
                         attention_backward_plain, attention_plain)


def cross_attention_packed_plain(q, k, v, scale: float,
                                 num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    return attention_plain(q, k, v, scale, num_heads)


def cross_attention_packed_backward_plain(q, k, v, out, lse, dout,
                                          scale: float, num_heads: int):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv)."""
    return attention_backward_plain(q, k, v, out, lse, dout, scale,
                                    num_heads)[:3]


class _CrossAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        # the forward kernel's operator (ops/_library.py) launches and counts
        op = torch.ops.wm.cross_attention_packed
        if not any(ctx.needs_input_grad[:3]):
            return op.default(q, k, v, scale, num_heads)
        out, lse = op.lse(q, k, v, scale, num_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.num_heads = scale, num_heads
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward_launch(
            q, k, v, out, lse, grad.contiguous(), ctx.scale,
            ctx.num_heads, wrapper=cross_attention_packed)[:3]
        return dq, dk, dv, None, None


def cross_attention_packed(q, k, v, scale: float,
                           num_heads: int) -> torch.Tensor:
    """q (B, N, C) head-packed; k, v (B, M, C). Returns (B, N, C)."""
    if q.device.type == "cpu":
        return cross_attention_packed_plain(q, k, v, scale, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _CrossAttentionFn.apply(q, k, v, float(scale), num_heads)


cross_attention_packed.launches = 0
# backward kernels launched, counted where each is launched: the dq kernel
# and the dk/dv kernel, one of each per backward
cross_attention_packed.backward_dq_launches = 0
cross_attention_packed.backward_dkv_launches = 0
