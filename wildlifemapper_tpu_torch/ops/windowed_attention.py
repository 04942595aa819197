"""Per-window-head attention with decomposed rel-pos bias (K6), the grouped
("v1") layout.

Replaces wildlifemapper_tpu/ops/windowed_attention.py::
windowed_attention_rel_pos (:111; forward kernel :52 at :144, backward
kernel :64 at :173) in the 8 windowed ViT-B blocks when
`attn_impl="grouped"`: q, k, v (BWH, N, D) per window-head, BWH = B*25*12
with N = 196 (window 14 on the 64-grid padded to 70) or B*16*12 with N = 144
(window 12 on the 48-grid); tables (BWH, N, h) and (BWH, N, w). A global
block on a grid of fewer than GLOBAL_N_THRESHOLD tokens lands here too.

The Pallas kernel held a group of 16 whole windows on chip with a one-pass
softmax and, in the backward, a second softmax and delta = sum p*dp. In bf16
at d = 64 or 80 a window of up to 208 tokens runs the resident bodies
(csrc/grouped_attention_resident.cu, grouped_attention_bwd_resident.cu): one
block a window-head with Q, K and V whole in shared memory, a one-pass
softmax that writes lse when a gradient is recorded, and one backward kernel
that takes p = exp(s - lse), delta = rowsum(do * o), dq, dk, dv and the table
gradients; the bias enters as a product with a one-hot expansion, as the
Pallas call's E/T operands did. In f32 the same windows run the
register-tiled f32 window bodies both ways
(csrc/grouped_attention_fwd_f32_window.cu,
grouped_attention_bwd_f32_window.cu: one block a window-head; the forward an
online softmax over slabs of keys, the backward one kernel that takes delta
itself). d = 32, d = 128 and a global block of more tokens still run the
tile bodies of K5 (csrc/grouped_attention.cu and
grouped_attention_bwd.cu; ops/flash_attention.py): 64-key tiles, an online
softmax, a plain delta pass and two backward kernels. See the sources'
headers for what bounds each on the H100. The group padding of the Pallas
call is not carried over.

On a CPU tensor the wrapper runs the plain version and autograd
differentiates it; on a CUDA tensor it launches the kernels or raises,
the forward through its operator (ops/_library.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .flash_attention import (_launch, grouped_attention_backward_plain,
                              grouped_attention_plain)


def _check_tables(q, rel_h, rel_w):
    for name, t in (("rel_h", rel_h), ("rel_w", rel_w)):
        if t is None or t.dim() != 3 or t.shape[:2] != q.shape[:2]:
            raise ValueError(
                f"{name} is not (BWH, N, g) for q {tuple(q.shape)}: "
                f"{None if t is None else tuple(t.shape)}")


def windowed_attention_rel_pos_plain(q, k, v, rel_h, rel_w, scale: float,
                                     grid_hw: Tuple[int, int],
                                     return_lse: bool = False):
    """Plain PyTorch version of the kernel (same rounding points)."""
    _check_tables(q, rel_h, rel_w)
    return grouped_attention_plain(q, k, v, rel_h, rel_w, scale, grid_hw,
                                   return_lse)


def windowed_attention_rel_pos_backward_plain(q, k, v, rel_h, rel_w, out,
                                              lse, dout, scale: float,
                                              grid_hw: Tuple[int, int]):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv, drel_h,
    drel_w) from the forward's out and (BWH, N) lse."""
    _check_tables(q, rel_h, rel_w)
    return grouped_attention_backward_plain(q, k, v, rel_h, rel_w, out, lse,
                                            dout, scale, grid_hw)


def windowed_attention_rel_pos(q, k, v, rel_h, rel_w, scale: float,
                               grid_hw: Tuple[int, int]) -> torch.Tensor:
    """q/k/v: (BWH, N, D) per window-head; rel_h: (BWH, N, h),
    rel_w: (BWH, N, w) with h*w == N. Returns (BWH, N, D)."""
    if q.device.type == "cpu":
        return windowed_attention_rel_pos_plain(q, k, v, rel_h, rel_w, scale,
                                                grid_hw)
    _check_tables(q, rel_h, rel_w)
    return _launch(windowed_attention_rel_pos, q, k, v, rel_h, rel_w, scale,
                   grid_hw)


windowed_attention_rel_pos.launches = 0
# backward kernels launched, counted where each is launched: the one-kernel
# backward of the resident body, or the dq (+ drel) kernel and the dk/dv
# kernel of the tile bodies, one of each per backward
windowed_attention_rel_pos.backward_launches = 0
windowed_attention_rel_pos.backward_dq_launches = 0
windowed_attention_rel_pos.backward_dkv_launches = 0
