"""SAM/ViTDet image encoder (counterpart of wildlifemapper_tpu/models/vit.py;
reference image_encoder.py: ImageEncoderViT :17-138, Block :141-204,
Attention :207-262).

Token grids are NHWC (B, H, W, C). With use_flash and attn_impl "packed",
attention runs the hand-written kernels on the packed (B, N, 3C) qkv:
windowed attention (K1) below GLOBAL_N_THRESHOLD tokens, global attention
(K2) at or above it, and every block's MLP runs the fused MLP kernel (K3).
With attn_impl "grouped" the qkv is split into per-head (B*heads, N, hd)
operands, as the reference does, and attention runs the grouped kernels:
K6 below the threshold, K5 at or above it; the MLP is the plain one.

With remat_blocks a block keeps, for the backward, its input and its
attention output and recomputes the rest there (the JAX package's remat
policy, vit.py:381-391): see Block.

Under tensor parallelism (parallel/mesh.py::shard_model) a block's
attention holds whole heads of q, k and v and proj's matching input
columns, and its MLP a slice of the hidden width: the kernels run on this
rank's heads or hidden shard, and each of the two sums over the model group
runs outside the remat segments (Block).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import rel_pos as rel_pos_ops
from ..ops import windows as window_ops
from ..ops.flash_attention import flash_attention_rel_pos
from ..ops.flash_attention_v2 import flash_attention_packed
from ..ops.fused_mlp import outputs_unread
from ..ops.windowed_attention import windowed_attention_rel_pos
from ..ops.windowed_attention_v2 import windowed_attention_packed
from ..parallel.tensor_parallel import copy_to_model
from .common import LayerNorm, Linear, MLPBlock

# Token-count boundary between the windowed kernel and the global kernel, as
# in the JAX package (vit.py:35): a global block on a grid of fewer tokens
# goes through the windowed kernel. Patchable in tests.
GLOBAL_N_THRESHOLD = 1024


class PatchEmbed(nn.Module):
    """16x16/16 conv patch embedding, NHWC in -> (B, H/16, W/16, C)
    (reference image_encoder.py:386-417), computed as space-to-depth plus
    one matmul. `proj` keeps the Conv2d parameter layout."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 16):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, hh, ww, c = x.shape
        gh, gw = hh // p, ww // p
        patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, gh, gw, p * p * c)
        w = self.proj.weight                       # (O, C, p, p)
        k2 = w.permute(0, 2, 3, 1).reshape(w.shape[0], p * p * c)
        out = F.linear(patches, k2.to(x.dtype))
        return out + self.proj.bias.to(x.dtype)


class RelPosAttention(nn.Module):
    """Multi-head attention with decomposed relative-position bias
    (reference image_encoder.py:207-262) on (B, H, W, C) grids.

    `table_size` is the grid the rel-pos parameters are sized for. On a
    smaller input grid (content crop) the tables are centre-sliced: the
    patch resolution is unchanged, so relative distance d maps to the same
    row as on the full grid. With `remat` (the attention segment of a remat
    Block) proj, the segment's last product, runs no product in the
    segment's recompute (models/common.py: Linear.forward_in_remat).

    Split over the model axis, `num_heads` and `width` are this rank's (its
    heads, heads x head_dim): qkv holds the rows [q, k, v] of those heads,
    so the packed (B, N, 3 * width) operand is what K1 / K2 take, and proj
    is the matching row split. The rel-pos tables stay whole on every rank
    and reach the attention through copy_to_model, which sums their
    gradient over the ranks' heads.
    """

    def __init__(self, dim: int, num_heads: int, table_size: Tuple[int, int],
                 qkv_bias: bool = True, use_rel_pos: bool = True,
                 use_flash: bool = False, attn_impl: str = "packed",
                 remat: bool = False):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.use_rel_pos = use_rel_pos
        self.use_flash = use_flash
        self.attn_impl = attn_impl
        self.remat = remat
        self.head_dim = head_dim = dim // num_heads
        self.width = dim              # this rank's q (k, v) width
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * table_size[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * table_size[1] - 1, head_dim))

    def _tables(self, h: int, w: int, dt: torch.dtype):
        rh, rw = self.rel_pos_h, self.rel_pos_w
        if rh.shape[0] > 2 * h - 1:
            off = (rh.shape[0] + 1) // 2 - h
            rh = rh[off:off + 2 * h - 1]
        if rw.shape[0] > 2 * w - 1:
            off = (rw.shape[0] + 1) // 2 - w
            rw = rw[off:off + 2 * w - 1]
        return rh.to(dt), rw.to(dt)

    def tp_width(self) -> int:
        """What a model axis must divide to split the layer: its heads."""
        return self.num_heads

    def tp_split(self, group, ranks: int, rank: int) -> None:
        """Run as this rank's heads (parallel/mesh.py::shard_model)."""
        self.num_heads //= ranks
        self.width //= ranks
        self.qkv.split, self.qkv.group = "column", group
        self.proj.split, self.proj.group = "row", group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj.finish(self.partial(x))

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The attention's output, or with a split this rank's share of it
        (proj's product over its heads, without the bias)."""
        b, h, w, _ = x.shape
        n = h * w
        dt = x.dtype
        heads = self.num_heads
        head_dim = self.head_dim
        width = self.width
        scale = head_dim ** -0.5
        if self.use_flash and not self.use_rel_pos and n >= GLOBAL_N_THRESHOLD:
            raise ValueError(
                "global attention without rel-pos is unsupported under "
                "use_flash_attention: the global kernel takes the rel-pos "
                "tables (set use_rel_pos=True or use_flash_attention=False)")

        qkv = self.qkv.partial(x.reshape(b, n, self.dim))     # (B, N, 3C)
        if self.use_rel_pos:
            rph, rpw = self._tables(h, w, dt)
            rph = copy_to_model(rph, self.qkv.group)
            rpw = copy_to_model(rpw, self.qkv.group)

        if (self.use_flash and self.use_rel_pos
                and self.attn_impl == "packed"):
            rh_sel = rel_pos_ops.select_rel_pos(rph, h, h)    # (h, kh, d)
            rw_sel = rel_pos_ops.select_rel_pos(rpw, w, w)    # (w, kw, d)
            q5 = qkv[:, :, :width].reshape(b, h, w, heads, head_dim)
            rel_h = torch.einsum("brced,rkd->brcek", q5, rh_sel
                                 ).reshape(b, n, heads, h)
            rel_w = torch.einsum("brced,ckd->brcek", q5, rw_sel
                                 ).reshape(b, n, heads, w)
            kernel = (windowed_attention_packed if n < GLOBAL_N_THRESHOLD
                      else flash_attention_packed)
            out = kernel(qkv, rel_h.contiguous(), rel_w.contiguous(), scale,
                         heads, (h, w))
        else:
            qkv = qkv.reshape(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
            qkv = qkv.reshape(3, b * heads, n, head_dim)
            q, k, v = qkv[0], qkv[1], qkv[2]
            rel_h = rel_w = None
            if self.use_rel_pos:
                rel_h, rel_w = rel_pos_ops.decomposed_rel_pos_tables(
                    q, rph, rpw, (h, w), (h, w))

            if self.use_flash and n >= GLOBAL_N_THRESHOLD:
                out = flash_attention_rel_pos(q, k, v, rel_h, rel_w, scale,
                                              (h, w))
            elif self.use_flash and rel_h is not None:
                # the grouped small-window path: one window-head per batch row
                out = windowed_attention_rel_pos(
                    q, k, v, rel_h.reshape(-1, n, h), rel_w.reshape(-1, n, w),
                    scale, (h, w))
            else:
                attn = torch.matmul((q * scale).float(),
                                    k.float().transpose(1, 2))
                if rel_h is not None:
                    attn = rel_pos_ops.add_decomposed_rel_pos(attn, rel_h,
                                                              rel_w)
                attn = torch.softmax(attn, dim=-1).to(dt)
                out = torch.matmul(attn, v)
            out = out.reshape(b, heads, n, head_dim).permute(0, 2, 1, 3)
            out = out.reshape(b, n, width)
        if self.remat and torch.is_grad_enabled():
            out = self.proj.forward_in_remat(out)
        else:
            out = self.proj.partial(out)
        return out.reshape(b, h, w, self.dim)


def _recompute_contexts():
    """checkpoint's context_fn for a remat segment: nothing around the
    forward, `outputs_unread` around the recompute."""
    return contextlib.nullcontext(), outputs_unread()


class Block(nn.Module):
    """Pre-norm transformer block with optional windowing
    (reference image_encoder.py:141-204).

    With `remat` and gradients enabled the block runs as two segments of
    torch.utils.checkpoint (non-reentrant, which needs no parameter of the
    block to take a gradient: in the fine-tune only the input carries one),
    which keep for the backward only
    their inputs: the block's input and its attention output (after
    window_unpartition, before the residual add), the JAX package's
    save_only_these_names("attn_out"). The backward recomputes norm1, qkv,
    the rel-pos tables and the attention forward (its kernel launched
    again) from the input, and the residual add and norm2 from both;
    neither proj's product nor the MLP's forward runs again, since their
    backward reads their inputs and not their outputs (`outputs_unread`
    around each segment's recompute: proj keeps its input and the weight,
    the MLP's dh kernel recomputes the hidden from the MLP's input). The
    attention segment ends at proj: window_unpartition runs outside it,
    where it saves nothing. The blocks draw no random numbers, so the
    recompute is the forward's own arithmetic.

    Split over the model axis, the segments end at the partial products
    of proj and of the MLP, and their sums over the model group (and the
    row splits' biases) run after each segment, outside it: a recompute
    issues no collective, which a rank could not match on its peers (the
    non-reentrant recompute runs when the backward first needs a saved
    tensor)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, use_rel_pos: bool = True,
                 window_size: int = 0,
                 table_size: Tuple[int, int] = (64, 64),
                 use_flash: bool = False, attn_impl: str = "packed",
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        self.attn = RelPosAttention(
            dim, num_heads,
            (window_size, window_size) if window_size > 0 else table_size,
            qkv_bias=qkv_bias, use_rel_pos=use_rel_pos, use_flash=use_flash,
            attn_impl=attn_impl, remat=remat)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio),
                            use_fused=use_flash and attn_impl == "packed")

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        """norm1 -> (windows) -> attention, proj's product included (this
        rank's share of it under a split)."""
        x = self.norm1(x)
        if self.window_size > 0:
            x, _ = window_ops.window_partition(x, self.window_size)
        return self.attn.partial(x)

    def _attention(self, x: torch.Tensor, attend) -> torch.Tensor:
        """attend(x), back on x's grid from the windows, summed over the
        model group."""
        out = attend(x)
        if self.window_size > 0:
            h, w, ws = x.shape[1], x.shape[2], self.window_size
            out = window_ops.window_unpartition(
                out, ws, (h + (-h) % ws, w + (-w) % ws), (h, w))
        return self.attn.proj.finish(out)

    def _residual_mlp(self, shortcut: torch.Tensor, attn_out: torch.Tensor):
        """(the residual sum, the MLP's output or this rank's share of
        it)."""
        x = shortcut + attn_out
        return x, self.mlp.partial(self.norm2(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            x, mlp_out = self._residual_mlp(
                x, self._attention(x, self._attend))
            return x + self.mlp.finish(mlp_out)
        attn_out = self._attention(x, lambda t: checkpoint(
            self._attend, t, use_reentrant=False, preserve_rng_state=False,
            context_fn=_recompute_contexts))
        x, mlp_out = checkpoint(self._residual_mlp, x, attn_out,
                                use_reentrant=False, preserve_rng_state=False,
                                context_fn=_recompute_contexts)
        return x + self.mlp.finish(mlp_out)


class Neck(nn.Sequential):
    """1x1 conv -> LN -> 3x3 conv -> LN down to out_chans
    (reference image_encoder.py:105-121), NHWC in and out. Indexed like the
    reference's Sequential so the state-dict names are neck.0 ... neck.3."""

    def __init__(self, dim: int, out_chans: int = 256):
        super().__init__(
            nn.Conv2d(dim, out_chans, 1, bias=False), LayerNorm(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm(out_chans))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, ln1, conv2, ln2 = self
        dt = x.dtype
        x = F.conv2d(x.permute(0, 3, 1, 2), conv1.weight.to(dt))
        x = ln1(x.permute(0, 2, 3, 1))
        x = F.conv2d(x.permute(0, 3, 1, 2), conv2.weight.to(dt), padding=1)
        return ln2(x.permute(0, 2, 3, 1))


class ImageEncoderViT(nn.Module):
    """Patch embed + abs pos + HFC adaptor + ViT blocks + neck
    (reference image_encoder.py:17-138). forward(images NHWC, hfc NHW1)
    -> (B, grid, grid, out_chans)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 qkv_bias: bool = True, use_abs_pos: bool = True,
                 use_rel_pos: bool = True, window_size: int = 14,
                 global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11),
                 hfc_embed_dim: int = 1024, hfc_num_heads: int = 8,
                 hfc_ffn_dim: int = 1024, hfc_proj_dim: int = 1024,
                 hfc_dropout: float = 0.1, use_flash: bool = False,
                 attn_impl: str = "packed",
                 content_grid: Optional[int] = None,
                 hfc_scrambled_reshape: bool = True,
                 remat_blocks: bool = False):
        super().__init__()
        from .adaptor import CrossAttentionHfcPatch

        self.patch_size = patch_size
        self.grid = img_size // patch_size
        self.content_grid = content_grid
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size)
        self.hfc_embed = PatchEmbed(1, hfc_embed_dim, patch_size)
        self.pos_embed = (nn.Parameter(
            torch.zeros(1, self.grid, self.grid, embed_dim))
            if use_abs_pos else None)
        self.hfc_attn = CrossAttentionHfcPatch(
            d_model=embed_dim, hfc_dim=hfc_embed_dim, proj_dim=hfc_proj_dim,
            num_heads=hfc_num_heads, ffn_dim=hfc_ffn_dim,
            dropout=hfc_dropout, grid_size=self.grid, use_flash=use_flash,
            compat_scrambled_reshape=hfc_scrambled_reshape)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio=mlp_ratio,
                  qkv_bias=qkv_bias, use_rel_pos=use_rel_pos,
                  window_size=0 if i in global_attn_indexes else window_size,
                  table_size=(self.grid, self.grid), use_flash=use_flash,
                  attn_impl=attn_impl, remat=remat_blocks)
            for i in range(depth))
        self.neck = Neck(embed_dim, out_chans)

    def forward(self, x: torch.Tensor, x_hfc: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        in_grid = x.shape[1] // self.patch_size
        x = self.patch_embed(x)
        if self.pos_embed is not None:
            x = x + self.pos_embed[:, :in_grid, :in_grid].to(x.dtype)
        hfc_emb = self.hfc_embed(x_hfc)
        x = self.hfc_attn(hfc_emb, x, deterministic=deterministic,
                          generator=generator) + x
        if self.content_grid is not None and self.content_grid < in_grid:
            # Pad tokens beyond the content are bias-only: drop them before
            # the O(N^2) blocks.
            x = x[:, :self.content_grid, :self.content_grid, :]
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x)
