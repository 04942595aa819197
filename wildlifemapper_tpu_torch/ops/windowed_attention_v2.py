"""Packed windowed attention with decomposed rel-pos bias (K1).

Replaces wildlifemapper_tpu/ops/windowed_attention_v2.py::
windowed_attention_packed (:200) and its backward kernel (_bwd_kernel :125)
in the 8 windowed ViT-B blocks: qkv (BW, N, 3C) as the qkv GEMM emits it, N = 196 (window 14
on the 64-grid padded to 70, BW = B*25) or 144 (window 12 on the 48-grid,
BW = B*16). In bf16 at d = 64 a window of up to 208 tokens runs the resident
body (csrc/attention_resident.cu: one block a window-head, Q, K and V whole in
shared memory; see csrc/attention_fwd_resident.cuh for what bounds it on the
H100 and how the design answers it). f32, d = 32 and a global block of more
tokens that lands here still run the tile body of csrc/attention.cu (shared
with K2 and K4; csrc/attention_fwd.cuh).
The rel tables are unpadded (BW, N, H, gh) / (BW, N, H, gw): the 16-lane
packing of the Pallas `pack_rel_tables` was a TPU tiling artefact.

The backward runs on the lse the forward writes when a gradient is recorded:
for the resident body one kernel a launch (csrc/attention_bwd_resident.cu:
delta, dq, dk, dv and drel of a window-head from one block), else a plain
delta pass and the two kernels of csrc/attention_bwd.cu (dq + drel, then
dk/dv); see ops/_attention.py for how that relates to the Pallas backward,
which recomputes a full softmax. Gradients come back in the forward's layouts:
dqkv packed (BW, N, 3C), drel (BW, N, H, gh/gw).

On a CPU tensor the wrapper runs the plain version and autograd
differentiates it; on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._attention import (attention_backward_launch,
                         attention_backward_plain, attention_launch,
                         attention_plain)


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


def packed_attention_backward_plain(qkv, rel_h, rel_w, out, lse, dout,
                                    scale: float, num_heads: int):
    """Plain PyTorch version of the packed backward (K1 and K2): returns
    (dqkv, drel_h, drel_w) with the kernels' rounding points."""
    q, k, v = _split(qkv)
    dq, dk, dv, drh, drw = attention_backward_plain(
        q, k, v, out, lse, dout, scale, num_heads, rel_h, rel_w)
    return torch.cat([dq, dk, dv], dim=-1), drh, drw


windowed_attention_packed_backward_plain = packed_attention_backward_plain


class PackedAttentionFn(torch.autograd.Function):
    """Forward and backward kernels on the packed qkv, shared by K1 and K2;
    `wrapper` is the public function whose launch counts move."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, scale, num_heads, wrapper):
        q, k, v = _split(qkv)
        need_grad = any(ctx.needs_input_grad[:3])
        res = attention_launch(q, k, v, scale, num_heads, rel_h, rel_w,
                               return_lse=need_grad)
        wrapper.launches += 1
        if not need_grad:
            return res
        out, lse = res
        ctx.save_for_backward(qkv, rel_h, rel_w, out, lse)
        ctx.scale, ctx.num_heads, ctx.wrapper = scale, num_heads, wrapper
        return out

    @staticmethod
    def backward(ctx, grad):
        qkv, rel_h, rel_w, out, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        _, _, _, drh, drw = attention_backward_launch(
            *_split(qkv), out, lse, grad.contiguous(), ctx.scale,
            ctx.num_heads, rel_h, rel_w, grads=_split(dqkv),
            want_drel=any(ctx.needs_input_grad[1:3]), wrapper=ctx.wrapper)
        return dqkv, drh, drw, None, None, None


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
    return PackedAttentionFn.apply(qkv, rel_h, rel_w, float(scale),
                                   num_heads, windowed_attention_packed)


windowed_attention_packed.launches = 0
# backward kernels launched, counted where each is launched: the one-kernel
# backward of the resident body, or the dq (+ drel) kernel and the dk/dv
# kernel of the tile bodies, one of each per backward
windowed_attention_packed.backward_launches = 0
windowed_attention_packed.backward_dq_launches = 0
windowed_attention_packed.backward_dkv_launches = 0
