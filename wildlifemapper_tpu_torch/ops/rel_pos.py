"""Decomposed relative-position bias (counterpart of
wildlifemapper_tpu/ops/rel_pos.py; reference image_encoder.py:314-383).

    bias[q, k] = <q_vec, Rh[dy]> + <q_vec, Rw[dx]>
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def rel_pos_index(q_size: int, k_size: int) -> np.ndarray:
    """Static (q_size, k_size) gather indices into a (2*max-1, C) table
    (reference image_encoder.py:340-344)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    q_coords = np.arange(q_size)[:, None] * q_ratio
    k_coords = np.arange(k_size)[None, :] * k_ratio
    rel = (q_coords - k_coords) + (k_size - 1) * k_ratio
    return rel.astype(np.int64)


@functools.lru_cache(maxsize=32)
def _rel_pos_index_on(q_size: int, k_size: int, device: torch.device
                      ) -> torch.Tensor:
    # Kept on the device: copying a host array in every forward would
    # synchronise the stream. Built outside inference mode so that a later
    # autograd caller may use it.
    with torch.inference_mode(False):
        return torch.from_numpy(rel_pos_index(q_size, k_size)).to(device)


def select_rel_pos(rel_pos: torch.Tensor, q_size: int, k_size: int
                   ) -> torch.Tensor:
    """Gather the (q_size, k_size, C) table from the (2*max-1, C) parameter."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        # Linear resample to the needed length (F.interpolate mode='linear',
        # align_corners=False), as the JAX package does.
        src_len = rel_pos.shape[0]
        pos = ((torch.arange(max_rel_dist, device=rel_pos.device) + 0.5)
               * (src_len / max_rel_dist) - 0.5)
        lo = pos.floor().to(torch.int64).clamp(0, src_len - 1)
        hi = (lo + 1).clamp(0, src_len - 1)
        frac = (pos - lo).clamp(0.0, 1.0)[:, None].to(rel_pos.dtype)
        rel_pos = rel_pos[lo] * (1.0 - frac) + rel_pos[hi] * frac
    return rel_pos[_rel_pos_index_on(q_size, k_size, rel_pos.device)]


def decomposed_rel_pos_tables(q: torch.Tensor, rel_pos_h: torch.Tensor,
                              rel_pos_w: torch.Tensor, q_hw, k_hw):
    """Project queries onto the axial rel-pos tables.

    q: (B*, qh*qw, C) per-head queries (unscaled). Returns
    rel_h (B*, qh, qw, kh) and rel_w (B*, qh, qw, kw).
    """
    qh, qw = q_hw
    kh, kw = k_hw
    rh = select_rel_pos(rel_pos_h, qh, kh)
    rw = select_rel_pos(rel_pos_w, qw, kw)
    rq = q.reshape(q.shape[0], qh, qw, q.shape[-1])
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
    return rel_h, rel_w


def add_decomposed_rel_pos(attn: torch.Tensor, rel_h: torch.Tensor,
                           rel_w: torch.Tensor) -> torch.Tensor:
    """attn (B*, N, kh*kw) + rel_h ⊕ rel_w, in attn's dtype.

    rel_h: (B*, qh, qw, kh), rel_w: (B*, qh, qw, kw).
    """
    bstar, n, _ = attn.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    attn = attn.reshape(bstar, n, kh, kw)
    attn = (attn + rel_h.reshape(bstar, n, kh, 1).to(attn.dtype)
            + rel_w.reshape(bstar, n, 1, kw).to(attn.dtype))
    return attn.reshape(bstar, n, kh * kw)
