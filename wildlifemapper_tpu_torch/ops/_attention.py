"""Shared plain versions and launchers of the attention kernels: the forward
(csrc/attention_fwd.cuh) and the two backward kernels
(csrc/attention_bwd.cuh), built once for the packed family K1, K2 and K4
(csrc/attention.cu, attention_bwd.cu) and once, with `scale_scores`, for the
grouped family K5 and K6 (csrc/grouped_attention.cu,
grouped_attention_bwd.cu). The streaming bf16 shapes (K2, K4, K5) run the
Hopper bodies instead (csrc/attention_fwd_sm90.cuh, attention_bwd_sm90.cuh,
built by the six `*_sm90.cu`; their dq kernel takes delta itself), and the
windowed bf16 shapes (K1, K6: one window of at most 208 tokens) the
resident bodies (csrc/attention_fwd_resident.cuh,
attention_bwd_resident.cuh, built by the four `*_resident.cu`), whose
backward is one kernel that also takes delta; at head dim 80 only the
forward: `attention_body` says which launch takes which, from its
direction, dtype and shapes alone.

Layouts are the JAX package's: q (B, N, C) and k, v (B, M, C), head h in
columns [h*d, (h+1)*d); for the packed qkv they are column slices of one
(B, N, 3C) tensor. Rel tables, when given, are (B, N, H, gh) and
(B, N, H, gw) with gh * gw == M. lse and delta are (B, N, H) float32. The
grouped (BH, N, d) operands of K5 and K6 are this layout with one head.

`scale_scores` is where the softmax scale enters: False rounds q*scale to
the input type before the QK product (flash_attention_v2.py:113), True
multiplies the f32 scores by it (flash_attention.py:108-110,
windowed_attention.py:58).

The backward follows the JAX package's packed backward kernels
(flash_attention_v2.py:229-319, cross_attention.py:90-146): scores are
recomputed with the forward's rounding points, p = exp(s - lse) from the
saved lse, delta = rowsum(do * o) per head in f32, ds and p rounded to the
input type before the gradient products. K1 and K6 compute the same
function (in bf16 in one kernel that takes delta itself, the resident body;
in f32 with the same two kernels); their Pallas backwards
(windowed_attention_v2.py:125, windowed_attention.py:64) recompute a full
softmax and take delta = sum p*dp instead, which is the same function up to
a rounding of the working type.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build


# the batch and the heads ride blockIdx.z and blockIdx.y of every launch
MAX_GRID_YZ = 65535

# From this many keys on, a bf16 launch at d = 64 or 128 (and the forward at
# d = 80) streams its tiles through the Hopper bodies
# (csrc/attention_fwd_sm90.cuh, attention_bwd_sm90.cuh).
STREAM_MIN_KEYS = 512
# Up to this many tokens a bf16 window at d = 64 (and the forward at d = 80)
# is held whole in shared memory by the resident bodies
# (csrc/attention_fwd_resident.cuh, attention_bwd_resident.cuh): 13 tiles of
# 16 rows; the main paths' windows
# are 196 (14 x 14) and 144 (12 x 12) tokens. Their rel tables are at most
# RESIDENT_MAX_GRID wide.
RESIDENT_MAX_TOKENS = 208
RESIDENT_MAX_GRID = 16
# The Hopper bodies take rel grids with gh + gw up to this many columns: the
# backward's one-hot products run over (rel_h | rel_w | 0) of this width,
# the forward stages the two tables side by side in rows of this width.
SM90_REL_COLS = 128
BODIES = ("mma", "sm90", "resident")
DIRECTIONS = ("forward", "backward")
# Head dims the kernels take: ViT-B / L / H run 64, 64, 80, the adaptor 128.
# 80 takes the Hopper and the resident bodies forward and the mma.sync / f32
# tile bodies backward (ViT-H is served, not trained).
HEAD_DIMS = (32, 64, 80, 128)


def attention_body(dtype: torch.dtype, d: int, nq: int, nk: int,
                   has_rel: bool,
                   grid_hw: Optional[Tuple[int, int]] = None,
                   direction: str = "forward") -> str:
    """Which kernel body a launch takes, from its direction, dtype and
    shapes alone: "sm90", the wgmma + TMA bodies, for bf16 at d = 64 or 128
    (forward also d = 80) with at least STREAM_MIN_KEYS keys (K2, K4 and K5
    on the main paths, ViT-H's K2 and K5, with or without rel tables, any
    number of queries); "resident", the one-block-a-window-head bodies, for
    bf16 at d = 64 (forward also d = 80) with rel tables of a grid `grid_hw`
    at most RESIDENT_MAX_GRID a side and nq == nk <= RESIDENT_MAX_TOKENS
    (every window of K1 and K6 on the main paths and ViT-H's; when `grid_hw`
    is not given the tables are taken to fit); else "mma", the mma.sync
    (bf16) or scalar (f32) tile bodies of csrc/attention_fwd.cuh /
    attention_bwd.cuh (f32, d = 32, the backward at d = 80, d = 128 or N != M
    below STREAM_MIN_KEYS keys, and a global block of 209 to 511 tokens that
    lands in K1 or K6). `direction` is "forward" or "backward": at d = 80 the
    two take different bodies, which compute the same function (the tile
    backward reads the lse of the Hopper or resident forward). Raises on
    what no body takes."""
    if direction not in DIRECTIONS:
        raise ValueError(f"direction {direction!r}: expected one of "
                         f"{DIRECTIONS}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported {HEAD_DIMS}")
    if nq < 1 or nk < 1:
        raise ValueError(f"empty attention: {nq} queries, {nk} keys")
    hopper = (64, 128, 80) if direction == "forward" else (64, 128)
    if dtype == torch.bfloat16 and d in hopper and nk >= STREAM_MIN_KEYS:
        return "sm90"
    resident = (64, 80) if direction == "forward" else (64,)
    if (dtype == torch.bfloat16 and d in resident and has_rel
            and nq == nk <= RESIDENT_MAX_TOKENS
            and (grid_hw is None or max(grid_hw) <= RESIDENT_MAX_GRID)):
        return "resident"
    return "mma"


def _pick_body(body, q, d, nk, rel_h, rel_w,
               direction: str = "forward") -> str:
    if body is None:
        has_rel = rel_h is not None
        return attention_body(
            q.dtype, d, q.shape[1], nk, has_rel,
            (rel_h.shape[-1], rel_w.shape[-1]) if has_rel else None,
            direction)
    if body not in BODIES:
        raise ValueError(f"body {body!r}: expected one of {BODIES}")
    return body


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, num_heads: int,
                    rel_h: Optional[torch.Tensor] = None,
                    rel_w: Optional[torch.Tensor] = None,
                    return_lse: bool = False, scale_scores: bool = False):
    """The kernel's function in plain PyTorch, with the same rounding
    points: q*scale rounded to the input type (or, with `scale_scores`, the
    f32 scores scaled), f32 scores and softmax,
    unnormalised p rounded to the input type before PV, out = acc / l.
    With return_lse also the (B, N, H) f32 log-sum-exp of the scores."""
    b, n, c = q.shape
    dt = q.dtype
    s, vh = _scores_plain(q, k, v, scale, num_heads, rel_h, rel_w,
                          scale_scores)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(dt).float(), vh)
    out = (acc / denom).to(dt).transpose(1, 2).reshape(b, n, c)
    if return_lse:
        return out, (mx + torch.log(denom))[..., 0].transpose(1, 2)
    return out


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, H, N, d) in f32."""
    b, n, c = t.shape
    return t.float().reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _scores_plain(q, k, v, scale, num_heads, rel_h, rel_w,
                  scale_scores=False):
    """f32 scores (B, H, N, M) with the forward's rounding points, and v per
    head."""
    b, n, _ = q.shape
    kt = _heads(k, num_heads).transpose(-1, -2)
    if scale_scores:
        s = torch.matmul(_heads(q, num_heads), kt) * scale
    else:
        s = torch.matmul(_heads((q.float() * scale).to(q.dtype), num_heads),
                         kt)
    if rel_h is not None:
        gh, gw = rel_h.shape[-1], rel_w.shape[-1]
        bias = (rel_h.float().permute(0, 2, 1, 3)[..., :, None]
                + rel_w.float().permute(0, 2, 1, 3)[..., None, :])
        s = s + bias.reshape(b, num_heads, n, gh * gw)
    return s, _heads(v, num_heads)


def attention_delta(dout: torch.Tensor, out: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """delta[b, q, h] = sum_d do * o in f32 (flash_attention_v2.py:342)."""
    b, n, c = out.shape
    return (dout.float() * out.float()).reshape(
        b, n, num_heads, c // num_heads).sum(-1)


def attention_backward_plain(q, k, v, out, lse, dout, scale: float,
                             num_heads: int,
                             rel_h: Optional[torch.Tensor] = None,
                             rel_w: Optional[torch.Tensor] = None,
                             scale_scores: bool = False):
    """The backward kernels' function in plain PyTorch, with their rounding
    points. Returns (dq, dk, dv, drel_h, drel_w); the last two are None
    without rel tables."""
    b, n, c = q.shape
    m = k.shape[1]
    dt = q.dtype

    def merge(t):                       # (B, H, N, d) -> (B, N, C)
        return t.transpose(1, 2).reshape(b, t.shape[2], c)

    s, vh = _scores_plain(q, k, v, scale, num_heads, rel_h, rel_w,
                          scale_scores)
    doh = _heads(dout, num_heads)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = attention_delta(dout, out, num_heads)
    ds = (p * (dp - delta.transpose(1, 2)[..., None])).to(dt).float()
    dq = merge(torch.matmul(ds, _heads(k, num_heads)) * scale).to(dt)
    dk = merge(torch.matmul(ds.transpose(-1, -2), _heads(q, num_heads))
               * scale).to(dt)
    dv = merge(torch.matmul(p.to(dt).float().transpose(-1, -2), doh)).to(dt)
    drh = drw = None
    if rel_h is not None:
        gh, gw = rel_h.shape[-1], rel_w.shape[-1]
        ds5 = ds.reshape(b, num_heads, n, gh, gw)
        drh = ds5.sum(-1).permute(0, 2, 1, 3).to(rel_h.dtype)
        drw = ds5.sum(-2).permute(0, 2, 1, 3).to(rel_w.dtype)
    return dq, dk, dv, drh, drw


def _check_operand(name: str, t: torch.Tensor, ref: torch.Tensor,
                   width: int) -> None:
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"{name}: expected {ref.dtype} on {ref.device}, "
                         f"got {t.dtype} on {t.device}")
    if t.dim() != 3 or t.shape[2] != width or t.stride(2) != 1:
        raise ValueError(f"{name}: expected (B, N, {width}) with unit column "
                         f"stride, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


def _check_attention(q, k, v, num_heads, rel_h, rel_w, extra=()):
    """Raise on anything the kernels do not take; returns (d, gh, gw).
    `extra` are further (name, tensor, rows) operands of shape
    (B, rows, C)."""
    b, n, c = q.shape
    m = k.shape[1]
    if c % num_heads:
        raise ValueError(f"C={c} not divisible by {num_heads} heads")
    if max(b, num_heads) > MAX_GRID_YZ:
        raise ValueError(f"batch {b} and heads {num_heads} ride the launch "
                         f"grid's y and z, at most {MAX_GRID_YZ} each")
    d = c // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported {HEAD_DIMS}")
    operands = (("q", q, n), ("k", k, m), ("v", v, m), *extra)
    for name, t, rows in operands:
        _check_operand(name, t, q, c)
        if t.shape[:2] != (b, rows):
            raise ValueError(f"{name}: expected {(b, rows, c)}, got "
                             f"{tuple(t.shape)}")
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
        # the tensor-core bodies move rows as 16-byte vectors
        for name, t, _ in operands:
            if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
                raise ValueError(f"{name}: bf16 rows must be 16-byte "
                                 f"aligned (strides {t.stride()})")
        if rel_h is not None and (rel_h.data_ptr() % 16
                                  or rel_w.data_ptr() % 16):
            raise ValueError("rel tables must start on a 16-byte boundary")
    return d, gh, gw


_ENTRY_SUFFIX = {"mma": "", "sm90": "_sm90", "resident": "_resident"}


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, num_heads: int,
                     rel_h: Optional[torch.Tensor] = None,
                     rel_w: Optional[torch.Tensor] = None,
                     return_lse: bool = False, scale_scores: bool = False,
                     body: Optional[str] = None):
    """Launch the forward kernel (csrc/attention.cu or, with `scale_scores`,
    csrc/grouped_attention.cu; for the shapes `attention_body` sends there,
    their `_sm90` or `_resident` counterparts) on CUDA tensors; raises on
    anything the kernel does not take. q/k/v may be column slices of one
    packed tensor: they are read by stride. With return_lse the kernel also
    writes the (B, N, H) f32 log-sum-exp the backward kernels need. `body`
    names a body outright, for timing one beside the other; the wrappers
    never pass it."""
    b, n, c = q.shape
    m = k.shape[1]
    d, gh, gw = _check_attention(q, k, v, num_heads, rel_h, rel_w)
    body = _pick_body(body, q, d, m, rel_h, rel_w, "forward")
    if body == "sm90" and gh + gw > SM90_REL_COLS:
        raise ValueError(f"rel grid {gh}x{gw}: the Hopper forward takes "
                         f"gh + gw <= {SM90_REL_COLS}")
    lib = _build.load_kernels()
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, n, num_heads), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    fwd = getattr(lib, ("wm_grouped_attention_fwd" if scale_scores
                        else "wm_attention_fwd") + _ENTRY_SUFFIX[body])
    err = fwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _ptr(rel_h), _ptr(rel_w), _ptr(lse),
        b, num_heads, n, m, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        gh, gw, float(scale), _build.stream_ptr(q))
    _build.check(err, "attention kernel")
    return (out, lse) if return_lse else out


def _backward_kernel_launch(kernel: int, q, k, v, dout, lse, delta, rel_h,
                            rel_w, dq, dk, dv, drh, drw, scale: float,
                            num_heads: int, d: int, gh: int, gw: int,
                            scale_scores: bool = False) -> None:
    """Launch one kernel of the tile bodies, csrc/attention_bwd.cu (with
    `scale_scores`, csrc/grouped_attention_bwd.cu), on checked operands: 0
    the dq (+ drel) kernel, 1 the dk/dv kernel; `delta` comes from the plain
    pass. Raises if the launch fails."""
    b, n, _ = q.shape
    lib = _build.load_kernels()
    entry = getattr(lib, "wm_grouped_attention_bwd" if scale_scores
                    else "wm_attention_bwd")
    err = entry(
        kernel, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        _ptr(rel_h), _ptr(rel_w), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(drh), _ptr(drw), b, num_heads, n, k.shape[1], d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        dv.stride(0), dv.stride(1), gh, gw, float(scale),
        _build.stream_ptr(q))
    _build.check(err, "attention backward kernel " + ("dq", "dk/dv")[kernel])


def sm90_scratch(q: torch.Tensor, num_heads: int, scale: float,
                 scale_scores: bool, has_rel: bool):
    """What the Hopper dq kernel leaves for the dk/dv kernel: delta
    (B, N, H) f32; round(q*scale) (B, N, C) in the packed family where the
    scale (in f32, as the kernels take it) is no power of two, so that
    round(q*scale).k is not (q.k)*scale; and with rel tables their rows side
    by side, (rel_h | rel_w | 0) in (B, N, H, SM90_REL_COLS)."""
    b, n, c = q.shape
    delta = torch.empty((b, n, num_heads), dtype=torch.float32,
                        device=q.device)
    pow2 = math.frexp(ctypes.c_float(scale).value)[0] == 0.5
    qs = (torch.empty((b, n, c), dtype=q.dtype, device=q.device)
          if not scale_scores and not pow2 else None)
    tab = (torch.empty((b, n, num_heads, SM90_REL_COLS), dtype=q.dtype,
                       device=q.device) if has_rel else None)
    return delta, qs, tab


def _sm90_backward_launch(kernel: int, q, k, v, dout, out, lse, scratch,
                          rel_h, rel_w, dq, dk, dv, drh, drw, scale: float,
                          num_heads: int, d: int, gh: int, gw: int,
                          scale_scores: bool = False) -> None:
    """Launch one kernel of the Hopper backward,
    csrc/attention_bwd_{dq,dkv}_sm90.cu (with `scale_scores`, their
    grouped_ counterparts), on checked operands; `scratch` is
    `sm90_scratch(...)`. 0, the dq kernel: dq, drel_h / drel_w when they are
    given, and the scratch: delta = rowsum(dout * out), round(q*scale), the
    tables side by side. 1, the dk/dv kernel: dk and dv, reading the
    scratch; it runs after the dq kernel on the same stream. Raises if the
    launch fails."""
    delta, qs, tab = scratch
    b, n, _ = q.shape
    lib = _build.load_kernels()
    family = "wm_grouped_attention_bwd" if scale_scores else "wm_attention_bwd"
    entry = getattr(lib, family + ("_dq_sm90", "_dkv_sm90")[kernel])
    err = entry(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        _ptr(qs), _ptr(tab), _ptr(rel_h), _ptr(rel_w), dq.data_ptr(),
        dk.data_ptr(),
        dv.data_ptr(), _ptr(drh), _ptr(drw), b, num_heads, n, k.shape[1], d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
        out.stride(0), out.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        dv.stride(0), dv.stride(1), gh, gw, float(scale),
        _build.stream_ptr(q))
    _build.check(err, "attention backward kernel "
                 + ("dq + delta", "dk/dv")[kernel])


def _resident_backward_launch(q, k, v, dout, out, lse, rel_h, rel_w, dq, dk,
                              dv, drh, drw, scale: float, num_heads: int,
                              d: int, gh: int, gw: int,
                              scale_scores: bool) -> None:
    """Launch the one backward kernel of csrc/attention_bwd_resident.cu
    (with `scale_scores`, of csrc/grouped_attention_bwd_resident.cu) on
    checked operands: delta, dq, dk, dv and, when drh / drw are given, the
    rel-table gradients of every window-head. Raises if the launch fails."""
    b, n, _ = q.shape
    lib = _build.load_kernels()
    entry = getattr(lib, ("wm_grouped_attention_bwd" if scale_scores
                          else "wm_attention_bwd") + "_resident")
    err = entry(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(rel_h),
        _ptr(rel_w), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(drh),
        _ptr(drw), b, num_heads, n, k.shape[1], d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
        out.stride(0), out.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        dv.stride(0), dv.stride(1), gh, gw, float(scale),
        _build.stream_ptr(q))
    _build.check(err, "windowed attention backward kernel")


def _count(wrapper, counter: str) -> None:
    if wrapper is not None:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def attention_backward_launch(q, k, v, out, lse, dout, scale: float,
                              num_heads: int,
                              rel_h: Optional[torch.Tensor] = None,
                              rel_w: Optional[torch.Tensor] = None,
                              grads=None, want_drel: bool = True,
                              wrapper=None, scale_scores: bool = False,
                              body: Optional[str] = None):
    """Launch the backward on CUDA tensors. For the "resident" body that is
    one kernel (csrc/attention_bwd_resident.cu or, with `scale_scores`,
    csrc/grouped_attention_bwd_resident.cu) that takes delta itself; for
    "sm90" the two kernels of csrc/attention_bwd_{dq,dkv}_sm90.cu (their
    grouped_ counterparts), the dq kernel taking delta itself and leaving
    it, with what else `sm90_scratch` names, for the dk/dv kernel; for
    "mma" the plain delta pass and the two kernels of
    csrc/attention_bwd.cu (csrc/grouped_attention_bwd.cu). The dq kernel
    also writes drel_h / drel_w when rel tables are given and `want_drel`;
    the dk/dv kernel runs after it. `grads`, when given, are the
    (dq, dk, dv) tensors to write, for example the column blocks of one
    packed dqkv; they are allocated otherwise. Returns (dq, dk, dv, drel_h,
    drel_w) like the plain version. `wrapper`, when given, is the public
    function on whose behalf the kernels run: its `backward_launches` goes
    up by one where the one-kernel backward is launched, its
    `backward_dq_launches` and `backward_dkv_launches` where each of the two
    kernels is. `body` names a body outright, for timing one beside the
    other; the wrappers never pass it."""
    b, n, c = q.shape
    m = k.shape[1]
    if grads is None:
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v))
    dq, dk, dv = grads
    d, gh, gw = _check_attention(
        q, k, v, num_heads, rel_h, rel_w,
        extra=(("dout", dout, n), ("out", out, n), ("dq", dq, n),
               ("dk", dk, m), ("dv", dv, m)))
    if (lse.shape != (b, n, num_heads) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse: expected contiguous float32 "
                         f"{(b, n, num_heads)}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    body = _pick_body(body, q, d, m, rel_h, rel_w, "backward")
    if body == "sm90" and gh + gw > SM90_REL_COLS:
        raise ValueError(f"rel grid {gh}x{gw}: the Hopper backward takes "
                         f"gh + gw <= {SM90_REL_COLS}")
    drh = drw = None
    if rel_h is not None and want_drel:
        drh, drw = torch.empty_like(rel_h), torch.empty_like(rel_w)
    if body == "resident":
        _resident_backward_launch(q, k, v, dout, out, lse, rel_h, rel_w, dq,
                                  dk, dv, drh, drw, scale, num_heads, d, gh,
                                  gw, scale_scores)
        _count(wrapper, "backward_launches")
        return dq, dk, dv, drh, drw
    counters = ("backward_dq_launches", "backward_dkv_launches")
    if body == "sm90":
        # the dq kernel takes delta itself and leaves it for the dk/dv kernel
        scratch = sm90_scratch(q, num_heads, scale, scale_scores,
                               rel_h is not None)
        for kernel, counter in enumerate(counters):
            _sm90_backward_launch(kernel, q, k, v, dout, out, lse, scratch,
                                  rel_h, rel_w, dq, dk, dv, drh, drw, scale,
                                  num_heads, d, gh, gw, scale_scores)
            _count(wrapper, counter)
        return dq, dk, dv, drh, drw
    delta = attention_delta(dout, out, num_heads).contiguous()
    for kernel, counter in enumerate(counters):
        _backward_kernel_launch(kernel, q, k, v, dout, lse, delta, rel_h,
                                rel_w, dq, dk, dv, drh, drw, scale,
                                num_heads, d, gh, gw, scale_scores)
        _count(wrapper, counter)
    return dq, dk, dv, drh, drw
