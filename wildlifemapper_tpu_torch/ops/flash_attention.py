"""Per-head global attention with decomposed rel-pos bias (K5), the grouped
("v1") layout.

Replaces wildlifemapper_tpu/ops/flash_attention.py::flash_attention_rel_pos
(:207; forward kernel :88 at :230, backward kernel :133 at :268) in the 4
global ViT-B blocks when `attn_impl="grouped"`: q, k, v (BH, N, D) per head,
BH = B*12, N = 4096 on the full canvas or 2304 under either crop; rel tables
(BH, qh, qw, W) as `decomposed_rel_pos_tables` gives them, or (BH, N, W).

    out = softmax((q . k^T) * scale + rel_h[q, k // w] + rel_w[q, k % w]) . v

The forward kernel is csrc/grouped_attention.cu: the streaming online-softmax
body of the packed family with the scale on the f32 scores, reading the
grouped operands as they are (one head, BH batches). The backward is the two
kernels of csrc/grouped_attention_bwd.cu (dq + drel walking keys, dk/dv
walking queries) on the lse the forward writes when a gradient is recorded;
the Pallas backward's accumulation into shared dk/dv blocks relies on the
TPU's in-order grid and is a race on a GPU (see that source's header).
Gradients of the tables come back in the shape that went in.

`GroupedAttentionFn` is shared with K6 (ops/windowed_attention.py).

On a CPU tensor the wrapper runs the plain version and autograd
differentiates it; on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._attention import (attention_backward_launch,
                         attention_backward_plain, attention_launch,
                         attention_plain)


def _check(q, k, v, rel_h, rel_w, grid_hw):
    """Raise on operands that are not the grouped layout; returns the
    tables as (BH, N, 1, gh) and (BH, N, 1, gw) views in q's dtype."""
    gh, gw = grid_hw
    if q.dim() != 3 or q.shape[1] != gh * gw:
        raise ValueError(f"q {tuple(q.shape)} is not (BH, {gh * gw}, D) for "
                         f"grid {tuple(grid_hw)}")
    bh, n, _ = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from q "
                             f"{tuple(q.shape)}")
    if rel_h is None or rel_w is None:
        raise ValueError("the grouped kernels need both rel tables")
    tables = []
    for name, t, g in (("rel_h", rel_h, gh), ("rel_w", rel_w, gw)):
        if t.shape[0] != bh or t.shape[-1] != g or t.numel() != bh * n * g:
            raise ValueError(f"{name} {tuple(t.shape)} is not (BH, qh, qw, "
                             f"{g}) or (BH, N, {g}) for q {tuple(q.shape)}")
        tables.append(t.reshape(bh, n, 1, g).to(q.dtype))
    return tables


def grouped_attention_plain(q, k, v, rel_h, rel_w, scale: float,
                            grid_hw: Tuple[int, int],
                            return_lse: bool = False):
    """The kernels' function in plain PyTorch, with their rounding points:
    f32 scores scaled after the product, the unnormalised p rounded to the
    input type before PV, out = acc / l. With return_lse also the (BH, N)
    f32 log-sum-exp of the scores."""
    rh, rw = _check(q, k, v, rel_h, rel_w, grid_hw)
    res = attention_plain(q, k, v, scale, 1, rh, rw, return_lse=return_lse,
                          scale_scores=True)
    return (res[0], res[1][..., 0]) if return_lse else res


def grouped_attention_backward_plain(q, k, v, rel_h, rel_w, out, lse, dout,
                                     scale: float, grid_hw: Tuple[int, int]):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv, drel_h,
    drel_w) from the forward's out and (BH, N) lse, the table gradients in
    the tables' shapes and dtypes."""
    rh, rw = _check(q, k, v, rel_h, rel_w, grid_hw)
    dq, dk, dv, drh, drw = attention_backward_plain(
        q, k, v, out, lse[..., None], dout, scale, 1, rh, rw,
        scale_scores=True)
    return (dq, dk, dv, drh.reshape(rel_h.shape).to(rel_h.dtype),
            drw.reshape(rel_w.shape).to(rel_w.dtype))


class GroupedAttentionFn(torch.autograd.Function):
    """Forward and backward kernels on the grouped operands, shared by K5
    and K6; `wrapper` is the public function whose launch counts move.
    rel_h and rel_w arrive as (BH, N, 1, g) in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale, wrapper):
        need_grad = any(ctx.needs_input_grad[:5])
        res = attention_launch(q, k, v, scale, 1, rel_h, rel_w,
                               return_lse=need_grad, scale_scores=True)
        wrapper.launches += 1
        if not need_grad:
            return res
        out, lse = res
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.scale, ctx.wrapper = scale, wrapper
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        grads = attention_backward_launch(
            q, k, v, out, lse, grad.contiguous(), ctx.scale, 1, rel_h, rel_w,
            want_drel=any(ctx.needs_input_grad[3:5]), wrapper=ctx.wrapper,
            scale_scores=True)
        return (*grads, None, None)


def _launch(wrapper, q, k, v, rel_h, rel_w, scale, grid_hw):
    """The CUDA side of both public wrappers: checks, then the kernels. The
    reshape and cast of the tables are differentiable, so their gradients
    come back in the shapes and dtypes that went in."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    rh, rw = _check(q, k, v, rel_h, rel_w, grid_hw)
    return GroupedAttentionFn.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), rh.contiguous(),
        rw.contiguous(), float(scale), wrapper)


# K5's plain versions are the family's, 3-D or 4-D tables alike
flash_attention_rel_pos_plain = grouped_attention_plain
flash_attention_rel_pos_backward_plain = grouped_attention_backward_plain


def flash_attention_rel_pos(q, k, v, rel_h, rel_w, scale: float,
                            grid_hw: Tuple[int, int]) -> torch.Tensor:
    """q, k, v: (BH, N, D); rel_h, rel_w: (BH, qh, qw, W) or (BH, N, W);
    scale: softmax scale; grid_hw: (h, w) token grid with h*w == N.
    Returns (BH, N, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_rel_pos_plain(q, k, v, rel_h, rel_w, scale,
                                             grid_hw)
    return _launch(flash_attention_rel_pos, q, k, v, rel_h, rel_w, scale,
                   grid_hw)


flash_attention_rel_pos.launches = 0
# backward kernels launched, counted where each is launched: the dq/drh/drw
# kernel and the dk/dv kernel, one of each per backward
# a grid of at most 208 tokens in bf16 takes the one-kernel resident backward
flash_attention_rel_pos.backward_launches = 0
flash_attention_rel_pos.backward_dq_launches = 0
flash_attention_rel_pos.backward_dkv_launches = 0


def reference_attention_rel_pos(q, k, v, rel_h, rel_w, scale: float,
                                grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Oracle that materialises the N x N scores, for the kernels' tests
    (wildlifemapper_tpu/ops/flash_attention.py:306-316)."""
    h, w = grid_hw
    bh, n, _ = q.shape
    s = torch.matmul(q * scale, k.transpose(1, 2)).float()
    s = s.reshape(bh, n, h, w)
    s = s + rel_h.reshape(bh, n, h)[..., :, None].float()
    s = s + rel_w.reshape(bh, n, w)[..., None, :].float()
    p = torch.softmax(s.reshape(bh, n, n), dim=-1)
    return torch.matmul(p.to(q.dtype), v)
