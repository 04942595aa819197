"""Shared plain version and launcher of the attention kernel
(csrc/attention.cu) behind K1, K2 and K4.

Layouts are the JAX package's: q (B, N, C) and k, v (B, M, C), head h in
columns [h*d, (h+1)*d); for the packed qkv they are column slices of one
(B, N, 3C) tensor. Rel tables, when given, are (B, N, H, gh) and
(B, N, H, gw) with gh * gw == M.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, num_heads: int,
                    rel_h: Optional[torch.Tensor] = None,
                    rel_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the same rounding
    points: q*scale rounded to the input type, f32 scores and softmax,
    unnormalised p rounded to the input type before PV, out = acc / l."""
    b, n, c = q.shape
    m = k.shape[1]
    d = c // num_heads
    dt = q.dtype
    qh = (q.float() * scale).to(dt).float()
    qh = qh.reshape(b, n, num_heads, d).transpose(1, 2)
    kh = k.float().reshape(b, m, num_heads, d).transpose(1, 2)
    vh = v.float().reshape(b, m, num_heads, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2))               # (B, H, N, M)
    if rel_h is not None:
        gh, gw = rel_h.shape[-1], rel_w.shape[-1]
        bias = (rel_h.float().permute(0, 2, 1, 3)[..., :, None]
                + rel_w.float().permute(0, 2, 1, 3)[..., None, :])
        s = s + bias.reshape(b, num_heads, n, gh * gw)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(dt).float(), vh)
    out = (acc / denom).to(dt)
    return out.transpose(1, 2).reshape(b, n, c)


def _check_operand(name: str, t: torch.Tensor, ref: torch.Tensor,
                   width: int) -> None:
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"{name}: expected {ref.dtype} on {ref.device}, "
                         f"got {t.dtype} on {t.device}")
    if t.dim() != 3 or t.shape[2] != width or t.stride(2) != 1:
        raise ValueError(f"{name}: expected (B, N, {width}) with unit column "
                         f"stride, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


def attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, num_heads: int,
                     rel_h: Optional[torch.Tensor] = None,
                     rel_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/attention.cu on CUDA tensors; raises on anything the
    kernel does not take. q/k/v may be column slices of one packed tensor:
    they are read by stride."""
    b, n, c = q.shape
    m = k.shape[1]
    if c % num_heads:
        raise ValueError(f"C={c} not divisible by {num_heads} heads")
    d = c // num_heads
    if d not in (32, 64, 128):
        raise ValueError(f"head dim {d} not supported (32, 64 or 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q, c)
    if k.shape[:2] != (b, m) or v.shape[:2] != (b, m):
        raise ValueError("k and v must both be (B, M, C)")
    gh = gw = 0
    if rel_h is not None:
        gh, gw = rel_h.shape[-1], rel_w.shape[-1]
        for name, t, g in (("rel_h", rel_h, gh), ("rel_w", rel_w, gw)):
            if (t.shape != (b, n, num_heads, g) or not t.is_contiguous()
                    or t.dtype != q.dtype or t.device != q.device):
                raise ValueError(f"{name}: expected contiguous "
                                 f"{(b, n, num_heads, g)} {q.dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        if gh * gw != m:
            raise ValueError(f"rel grid {gh}x{gw} does not cover {m} keys")
    if q.dtype == torch.bfloat16:
        # the tensor-core body moves k and v rows as 16-byte vectors
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
                raise ValueError(f"{name}: bf16 rows must be 16-byte "
                                 f"aligned (strides {t.stride()})")
    lib = _build.load_kernels()
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    null = None
    err = lib.wm_attention_fwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(),
        rel_h.data_ptr() if rel_h is not None else null,
        rel_w.data_ptr() if rel_w is not None else null,
        b, num_heads, n, m, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        gh, gw, float(scale), _build.stream_ptr(q))
    _build.check(err, "attention kernel")
    return out
