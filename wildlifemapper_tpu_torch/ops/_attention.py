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
backward is one kernel that also takes delta, at head dim 64 and 80 alike.
The f32 backward at the streaming shapes (K2, K5: d = 64 or 80, at least
512 keys) runs the register-tiled f32 body (csrc/attention_bwd_f32.cuh,
built by attention_bwd_f32.cu and grouped_attention_bwd_f32.cu; its dq
kernel takes delta itself), and the f32 windows the resident bodies take in
bf16 (K1, K6) the register-tiled f32 window bodies both ways: the backward
csrc/attention_bwd_f32_window.cuh (built by attention_bwd_f32_window.cu and
grouped_attention_bwd_f32_window.cu: one kernel a window-head that takes
delta itself), the forward csrc/attention_fwd_f32_window.cuh (built by
attention_fwd_f32_window.cu and grouped_attention_fwd_f32_window.cu: one or
two blocks a window-head, an online softmax over slabs of keys). The f32
forward at the streaming shapes (at least 512 keys: K2, K5 at d = 64 or 80
with or without rel tables, K4 at d = 128 without) runs the register-tiled
f32 forward (csrc/attention_fwd_f32.cuh, built by attention_fwd_f32.cu and
grouped_attention_fwd_f32.cu), so K2, K4 and K5 take one f32 body both
ways; K4's backward is csrc/attention_bwd_f32_d128.cuh (built by
attention_bwd_f32_d128.cu: a delta kernel, a dk/dv kernel that leaves ds in
a scratch, and a dq kernel that multiplies it by K). `attention_body` says
which launch takes which, from its direction, dtype and shapes alone.

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
function (in one kernel that takes delta itself: the resident body in bf16,
the f32 window body in f32); their Pallas backwards
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

# From this many keys on, a bf16 launch at d = 64, 80 or 128 streams its
# tiles through the Hopper bodies (csrc/attention_fwd_sm90.cuh,
# attention_bwd_sm90.cuh).
STREAM_MIN_KEYS = 512
# Up to this many tokens a bf16 window at d = 64 or 80 is held whole in
# shared memory by the resident bodies
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
# The register-tiled f32 body takes these head dims without rel tables
# (csrc/attention_fwd_f32.cuh forward, csrc/attention_bwd_f32_d128.cuh
# backward, K4's packed family) and F32_STREAM_DIMS with or without them,
# both ways (csrc/attention_fwd_f32.cuh forward, csrc/attention_bwd_f32.cuh
# backward): the forward any rel grid of gh + gw <= F32_FORWARD_REL_COLS,
# the backward a grid width `f32_key_tile` takes.
F32_PLAIN_DIMS = (128,)
F32_STREAM_DIMS = (64, 80)
F32_FORWARD_REL_COLS = 128
# The f32 forward's blocks of queries, its K / V tiles of keys and, at
# d = 64 and 80, each warp's p strip: F32_FORWARD_P_KEYS keys of 16 rows
# padded to F32_FORWARD_P_LD floats (csrc/attention_fwd_f32.cuh).
F32_FORWARD_ROWS = 128
F32_FORWARD_KEYS = 128
F32_FORWARD_P_KEYS = 32
F32_FORWARD_P_LD = 24
# The d-128 f32 backward's ds scratch rows are the queries rounded up to this
# (the dq kernel's blocks of queries).
F32_DS_ROW = 128
# The f32 streaming backward's key tiles (csrc/attention_bwd_f32.cuh): a
# tile is a whole number of rows of the rel grid, 64 keys or, where the grid
# width divides 48 and not 64, 48; grids of another width stay on the tile
# body.
F32_KEY_TILES = (64, 48)
# The f32 window bodies (csrc/attention_bwd_f32_window.cuh,
# attention_fwd_f32_window.cuh) walk slabs of this many rows; the backward's
# blocks are 5 warps up to 160 tokens and 7 up to 224, the forward's
# (`f32_window_forward_smem_bytes`) 3, 4 or 7, whose p tile has rows of its
# resident rows + F32_WINDOW_FORWARD_PAD floats.
F32_WINDOW_SLAB = 32
F32_WINDOW_FORWARD_PAD = 16
BODIES = ("mma", "sm90", "resident", "f32", "f32_window")
DIRECTIONS = ("forward", "backward")
# Head dims the kernels take: ViT-B / L / H run 64, 64, 80, the adaptor 128.
# 80 takes the Hopper bodies and the resident bodies both ways, as 64 does.
HEAD_DIMS = (32, 64, 80, 128)


def f32_key_tile(gw: Optional[int]) -> Optional[int]:
    """The f32 streaming backward's key tile for a rel grid `gw` wide (None:
    no tables), or None where that body takes no such grid: gw a multiple of
    8, at least 16, dividing 64 or 48 (the kernels' `f32_key_tile`)."""
    if gw is None:
        return F32_KEY_TILES[0]
    if gw < 16 or gw % 8:
        return None
    return next((t for t in F32_KEY_TILES if t % gw == 0), None)


def f32_window_smem_bytes(d: int, tokens: int) -> int:
    """Shared memory of a block of the f32 window body for `tokens` tokens
    at head dim `d` (the kernel's `fw_smem_bytes`): two resident k-major
    tensors of 32 * warps rows, two stages of two slabs, the p / ds tile,
    lse and delta, and the tables (pass 1's rel_w of every row, or pass 2's
    two stages of a slab's rel_h | rel_w rows), in f32."""
    rows = 32 * (7 if tokens > 160 else 5)
    s, g = F32_WINDOW_SLAB, RESIDENT_MAX_GRID
    tables = max(g * rows, 2 * s * (2 * g + 1))
    return 4 * (2 * d * rows + 2 * 2 * s * (d + 4) + s * (rows + 4)
                + 2 * rows + tables)


def f32_window_forward_smem_bytes(d: int, tokens: int) -> int:
    """Shared memory of a block of the f32 window forward for `tokens`
    tokens at head dim `d` (the kernel's `fwf_smem_bytes`): the block's
    resident queries k-major, two stages of a K and a V slab, the p tile and
    both tables of every resident row, in f32. Its blocks are 3 warps up to
    160 tokens (two a window-head), then 4 at d 64 (two a window-head) and
    7 at d 80 (one)."""
    rows = 32 * (3 if tokens <= 160 else 4 if d == 64 else 7)
    s, g = F32_WINDOW_SLAB, RESIDENT_MAX_GRID
    return 4 * (d * rows + 2 * 2 * s * (d + 4)
                + s * (rows + F32_WINDOW_FORWARD_PAD) + 2 * g * rows)


def _f32_table_ld(g: int) -> int:
    """Row stride of a staged rel table g wide in the f32 forward: the least
    >= g that is 4 past a multiple of 8 (the kernel's `ff_tab_ld`)."""
    return 0 if g == 0 else (g + 3) // 8 * 8 + 4


def f32_forward_smem_bytes(d: int, gh: int = 0, gw: int = 0) -> int:
    """Shared memory of a block of the f32 forward at head dim `d` with a
    rel grid gh x gw (0 x 0: no tables), the kernel's `ff_smem_bytes`: the
    block's queries k-major, a K and a V tile (rows padded to d + 4), at
    d = 64 and 80 the warps' p strips, and the block's rows of both tables,
    in f32."""
    rows = F32_FORWARD_ROWS
    strips = 8 * F32_FORWARD_P_KEYS * F32_FORWARD_P_LD if d + 4 < rows + 4 \
        else 0
    return 4 * (d * rows + 2 * F32_FORWARD_KEYS * (d + 4) + strips
                + rows * (_f32_table_ld(gh) + _f32_table_ld(gw)))


def attention_body(dtype: torch.dtype, d: int, nq: int, nk: int,
                   has_rel: bool,
                   grid_hw: Optional[Tuple[int, int]] = None,
                   direction: str = "forward") -> str:
    """Which kernel body a launch takes, from its direction, dtype and
    shapes alone: "sm90", the wgmma + TMA bodies, for bf16 at d = 64, 80 or
    128 with at least STREAM_MIN_KEYS keys (K2, K4 and K5 on the main paths,
    ViT-H's K2 and K5, with or without rel tables, any number of queries);
    "resident", the one-block-a-window-head bodies, for
    bf16 at d = 64 or 80 with rel tables of a grid `grid_hw` at most
    RESIDENT_MAX_GRID a side and nq == nk <= RESIDENT_MAX_TOKENS (every
    window of K1 and K6 on the main paths and ViT-H's; when `grid_hw` is not
    given the tables are taken to fit); "f32", the register-tiled f32 body
    with at least STREAM_MIN_KEYS keys: both ways at d = 128 without tables
    (csrc/attention_fwd_f32.cuh, attention_bwd_f32_d128.cuh: K4 at N = M
    4096 and 2304, N != M, a tensor-parallel rank's 4 heads), and at d = 64
    or 80 (K2 and K5 on the main paths, ViT-H's at d 80, the tensor-parallel
    ranks'), forward (csrc/attention_fwd_f32.cuh) without tables or with a
    grid of gh + gw <= F32_FORWARD_REL_COLS, backward
    (csrc/attention_bwd_f32.cuh) without tables or with a grid whose width
    `f32_key_tile` takes (when `grid_hw` is not given the tables are taken
    to fit); "f32_window", the register-tiled f32 window bodies, for the
    f32 windows "resident" takes in bf16 (K1 and K6 on the main paths,
    ViT-H's d-80 windows) both ways: forward
    csrc/attention_fwd_f32_window.cuh, backward
    csrc/attention_bwd_f32_window.cuh; else "mma", the mma.sync (bf16) or
    scalar (f32) tile bodies of csrc/attention_fwd.cuh / attention_bwd.cuh
    (the f32 grids neither f32 body takes, d = 32, d = 128 with tables or
    below STREAM_MIN_KEYS keys, N != M below STREAM_MIN_KEYS keys, and a
    global block of 209 to 511 tokens that lands in K1 or K6). `direction`
    is "forward" or "backward": a bf16 shape, an f32 window and an f32
    streaming shape take the same body both ways, the last where both f32
    bodies take its grid (the main paths' 64- and 48-grids). Raises on what
    no body takes."""
    if direction not in DIRECTIONS:
        raise ValueError(f"direction {direction!r}: expected one of "
                         f"{DIRECTIONS}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported {HEAD_DIMS}")
    if nq < 1 or nk < 1:
        raise ValueError(f"empty attention: {nq} queries, {nk} keys")
    if (dtype == torch.bfloat16 and d in (64, 80, 128)
            and nk >= STREAM_MIN_KEYS):
        return "sm90"
    window = (d in (64, 80) and has_rel and nq == nk <= RESIDENT_MAX_TOKENS
              and (grid_hw is None or max(grid_hw) <= RESIDENT_MAX_GRID))
    if window:
        return "resident" if dtype == torch.bfloat16 else "f32_window"
    if dtype == torch.float32 and nk >= STREAM_MIN_KEYS:
        if d in F32_PLAIN_DIMS and not has_rel:
            return "f32"
        if d in F32_STREAM_DIMS and (not has_rel or grid_hw is None
                                       or _f32_takes_grid(grid_hw,
                                                          direction)):
            return "f32"
    return "mma"


def _f32_takes_grid(grid_hw: Tuple[int, int], direction: str) -> bool:
    """Whether the f32 streaming body at d = 64 or 80 takes a rel grid
    gh x gw: forward gh + gw <= F32_FORWARD_REL_COLS (the block's rows of
    both tables in shared memory), backward a width `f32_key_tile` takes."""
    if direction == "forward":
        return sum(grid_hw) <= F32_FORWARD_REL_COLS
    return f32_key_tile(grid_hw[1]) is not None


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


_ENTRY_SUFFIX = {"mma": "", "sm90": "_sm90", "resident": "_resident",
                 "f32": "_f32", "f32_window": "_f32_window"}


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
    their `_sm90`, `_resident`, `_fwd_f32` or `_fwd_f32_window`
    counterparts) on CUDA tensors; raises on
    anything the kernel does not take. q/k/v may be column slices of one
    packed tensor: they are read by stride. With return_lse the kernel also
    writes the (B, N, H) f32 log-sum-exp the backward kernels need. `body`
    names a body outright, for timing one beside the other; the wrappers
    never pass it."""
    b, n, c = q.shape
    m = k.shape[1]
    d, gh, gw = _check_attention(q, k, v, num_heads, rel_h, rel_w)
    body = _pick_body(body, q, d, m, rel_h, rel_w, "forward")
    if body == "f32_window":
        _check_f32_body(d, gw, rel_h is not None, [q, k, v], window=True)
        _check_f32_window(n, m, gh, gw)
    if body == "f32":
        _check_f32_body(d, gw, rel_h is not None,
                        [t for t in (q, k, v, rel_h, rel_w) if t is not None],
                        scale_scores=scale_scores, keys=m, gh=gh,
                        direction="forward")
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


def _f32_backward_launch(kernel: int, q, k, v, dout, out, lse, delta,
                         rel_h, rel_w, dq, dk, dv, drh, drw, scale: float,
                         num_heads: int, d: int, gh: int, gw: int,
                         scale_scores: bool = False) -> None:
    """Launch one kernel of the f32 streaming backward,
    csrc/attention_bwd_f32.cu (with `scale_scores`,
    csrc/grouped_attention_bwd_f32.cu), on checked operands. 0, the dq
    kernel: dq, drel_h / drel_w when they are given, and `delta` =
    rowsum(dout * out), (B, N, H) f32, which it writes. 1, the dk/dv kernel:
    dk and dv, reading that delta; it runs after the dq kernel on the same
    stream. Raises if the launch fails."""
    b, n, _ = q.shape
    lib = _build.load_kernels()
    entry = getattr(lib, ("wm_grouped_attention_bwd" if scale_scores
                          else "wm_attention_bwd") + "_f32")
    err = entry(
        kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        out.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(rel_h),
        _ptr(rel_w), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(drh),
        _ptr(drw), b, num_heads, n, k.shape[1], d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
        out.stride(0), out.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        dv.stride(0), dv.stride(1), gh, gw, float(scale),
        _build.stream_ptr(q))
    _build.check(err, "f32 attention backward kernel "
                 + ("dq + delta", "dk/dv")[kernel])


def f32_d128_scratch(q: torch.Tensor, k: torch.Tensor, num_heads: int):
    """What the d-128 f32 backward's kernels leave for the next: delta
    (B, N, H) f32 for the dk/dv kernel, and ds (B, H, M, N') f32 for the dq
    kernel, keys by rows, N' = N rounded up to F32_DS_ROW (2.15 GB at B 4,
    H 8, N = M 4096)."""
    b, n, _ = q.shape
    delta = torch.empty((b, n, num_heads), dtype=torch.float32,
                        device=q.device)
    width = -(-n // F32_DS_ROW) * F32_DS_ROW
    ds = torch.empty((b, num_heads, k.shape[1], width), dtype=torch.float32,
                     device=q.device)
    return delta, ds


def _f32_d128_backward_launch(kernel: int, q, k, v, dout, out, lse, scratch,
                              dq, dk, dv, scale: float,
                              num_heads: int) -> None:
    """Launch the d-128 f32 backward, csrc/attention_bwd_f32_d128.cu, on
    checked operands; `scratch` is `f32_d128_scratch(...)`. 0: the delta
    kernel and the dk/dv kernel, dk and dv, and delta and ds into the
    scratch; 1, the dq kernel: dq from ds, after them on the same stream.
    Raises if a launch fails."""
    delta, ds = scratch
    b, n, _ = q.shape
    entry = _build.load_kernels().wm_attention_bwd_f32_d128
    err = entry(
        kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        out.data_ptr(), lse.data_ptr(), delta.data_ptr(), ds.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, num_heads, n,
        k.shape[1], q.shape[2] // num_heads, ds.shape[3],
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
        out.stride(0), out.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        dv.stride(0), dv.stride(1), float(scale), _build.stream_ptr(q))
    _build.check(err, "f32 attention backward kernel "
                 + ("delta + dk/dv + ds", "dq from ds")[kernel])


def _check_f32_body(d: int, gw: int, has_rel: bool, tensors,
                    window: bool = False, scale_scores: bool = False,
                    keys: int = STREAM_MIN_KEYS, gh: int = 0,
                    direction: str = "backward") -> None:
    """What the f32 bodies take: f32 at d = 64 or 80, and (not the window
    body) at d = 128 without tables in the packed family (K4) from
    STREAM_MIN_KEYS `keys` on; rows and tables on 16-byte boundaries (their
    tiles arrive by 16-byte copies); the streaming body a rel grid
    `_f32_takes_grid` takes in its `direction` (forward gh + gw <=
    F32_FORWARD_REL_COLS, backward a width `f32_key_tile` takes), the window
    body one window (`_check_f32_window`)."""
    name = "f32_window" if window else "f32"
    if tensors[0].dtype != torch.float32 or d not in (64, 80) + (
            () if window else F32_PLAIN_DIMS):
        raise ValueError(f"the {name} body takes float32 at d = 64 or 80"
                         + ("" if window else ", or 128 without tables")
                         + f", got {tensors[0].dtype} at d = {d}")
    if d in F32_PLAIN_DIMS and (has_rel or scale_scores
                                or keys < STREAM_MIN_KEYS):
        raise ValueError(f"the {name} body takes d = {d} without rel tables "
                         f"in the packed family (K4) from {STREAM_MIN_KEYS} "
                         f"keys, got {keys} keys"
                         + (" with tables" if has_rel else "")
                         + (", the scale on the scores" if scale_scores
                            else ""))
    if not window and has_rel and not _f32_takes_grid((gh, gw), direction):
        raise ValueError(
            f"rel grid {gh}x{gw}: the f32 body takes "
            + (f"gh + gw <= {F32_FORWARD_REL_COLS} forward"
               if direction == "forward" else
               "widths of 16, 24, 32, 48 or 64 backward"))
    for i, t in enumerate(tensors):
        rows = t.dim() == 3
        if t.data_ptr() % 16 or (rows and (t.stride(0) % 4
                                           or t.stride(1) % 4)):
            raise ValueError(f"{name} body: operand {i} must be 16-byte "
                             f"aligned (strides {t.stride()})")


def _check_f32_window(n: int, m: int, gh: int, gw: int) -> None:
    """The windows the f32 window body takes: N == M <= RESIDENT_MAX_TOKENS
    with tables at most RESIDENT_MAX_GRID wide."""
    if n != m or n > RESIDENT_MAX_TOKENS or max(gh, gw) > RESIDENT_MAX_GRID:
        raise ValueError(f"the f32_window body takes N == M <= "
                         f"{RESIDENT_MAX_TOKENS} with tables at most "
                         f"{RESIDENT_MAX_GRID} wide, got N {n}, M {m}, grid "
                         f"{gh}x{gw}")


def window_backward_args(q, k, v, dout, out, lse, rel_h, rel_w, dq, dk, dv,
                         drh, drw, scale: float, num_heads: int, d: int,
                         gh: int, gw: int) -> tuple:
    """The arguments of a one-kernel windowed backward's C entry
    (`_build._ATTENTION_BWD_F32_WINDOW`; the resident entry takes the dtype
    code before them): pointers, shapes, the row strides of every operand,
    the grid, the scale and the stream."""
    b, n, _ = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _ptr(rel_h), _ptr(rel_w),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(drh),
            _ptr(drw), b, num_heads, n, k.shape[1], d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
            out.stride(0), out.stride(1),
            dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
            dv.stride(0), dv.stride(1), gh, gw, float(scale),
            _build.stream_ptr(q))


def _resident_backward_launch(q, *args, scale_scores: bool) -> None:
    """Launch the one backward kernel of csrc/attention_bwd_resident.cu
    (with `scale_scores`, of csrc/grouped_attention_bwd_resident.cu) on
    checked operands (`window_backward_args`' arguments): delta, dq, dk, dv
    and, when drh / drw are given, the rel-table gradients of every
    window-head. Raises if the launch fails."""
    entry = getattr(_build.load_kernels(),
                    ("wm_grouped_attention_bwd" if scale_scores
                     else "wm_attention_bwd") + "_resident")
    err = entry(_build.dtype_code(q), *window_backward_args(q, *args))
    _build.check(err, "windowed attention backward kernel")


def _f32_window_backward_launch(*args, scale_scores: bool) -> None:
    """Launch the one backward kernel of csrc/attention_bwd_f32_window.cu
    (with `scale_scores`, of csrc/grouped_attention_bwd_f32_window.cu) on
    checked operands, as `_resident_backward_launch`. Raises if the launch
    fails."""
    entry = getattr(_build.load_kernels(),
                    ("wm_grouped_attention_bwd" if scale_scores
                     else "wm_attention_bwd") + "_f32_window")
    err = entry(*window_backward_args(*args))
    _build.check(err, "f32 windowed attention backward kernel")


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
    csrc/grouped_attention_bwd_resident.cu) that takes delta itself, and so
    for "f32_window" (csrc/attention_bwd_f32_window.cu,
    csrc/grouped_attention_bwd_f32_window.cu); for
    "sm90" the two kernels of csrc/attention_bwd_{dq,dkv}_sm90.cu (their
    grouped_ counterparts), the dq kernel taking delta itself and leaving
    it, with what else `sm90_scratch` names, for the dk/dv kernel; for
    "f32" the two kernels of csrc/attention_bwd_f32.cu
    (csrc/grouped_attention_bwd_f32.cu), the dq kernel taking delta itself
    and leaving it for the dk/dv kernel, or at d = 128 those of
    csrc/attention_bwd_f32_d128.cu, the dk/dv kernel (after a delta kernel)
    first, leaving ds for the dq kernel (`f32_d128_scratch`); for "mma" the
    plain delta pass and
    the two kernels of
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
                                  gw, scale_scores=scale_scores)
        _count(wrapper, "backward_launches")
        return dq, dk, dv, drh, drw
    if body == "f32_window":
        _check_f32_body(d, gw, rel_h is not None,
                        [q, k, v, dout, out, dq, dk, dv], window=True)
        _check_f32_window(n, m, gh, gw)
        # one kernel, delta taken inside: no scratch, no plain pass
        _f32_window_backward_launch(q, k, v, dout, out, lse, rel_h, rel_w,
                                    dq, dk, dv, drh, drw, scale, num_heads,
                                    d, gh, gw, scale_scores=scale_scores)
        _count(wrapper, "backward_launches")
        return dq, dk, dv, drh, drw
    counters = ("backward_dq_launches", "backward_dkv_launches")
    if body == "f32":
        _check_f32_body(d, gw, rel_h is not None,
                        [t for t in (q, k, v, dout, out, dq, dk, dv, rel_h,
                                     rel_w) if t is not None],
                        scale_scores=scale_scores, keys=m, gh=gh)
        if d in F32_PLAIN_DIMS:
            # the delta kernel and the dk/dv kernel, which leaves ds for the
            # dq kernel: five products, no plain pass
            scratch = f32_d128_scratch(q, k, num_heads)
            for kernel, counter in enumerate(counters[::-1]):
                _f32_d128_backward_launch(kernel, q, k, v, dout, out, lse,
                                          scratch, dq, dk, dv, scale,
                                          num_heads)
                _count(wrapper, counter)
            return dq, dk, dv, drh, drw
        # the dq kernel takes delta itself and leaves it for the dk/dv kernel
        delta = torch.empty((b, n, num_heads), dtype=torch.float32,
                            device=q.device)
        for kernel, counter in enumerate(counters):
            _f32_backward_launch(kernel, q, k, v, dout, out, lse, delta,
                                 rel_h, rel_w, dq, dk, dv, drh, drw, scale,
                                 num_heads, d, gh, gw, scale_scores)
            _count(wrapper, counter)
        return dq, dk, dv, drh, drw
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
