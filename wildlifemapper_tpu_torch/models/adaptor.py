"""HFC -> patch cross-attention adaptor (counterpart of
wildlifemapper_tpu/models/adaptor.py; reference CrossAttentionHfcPatch,
image_encoder.py:452-516).

Both streams are projected to proj_dim with 1x1 convs, a learned positional
embedding is added to the HFC stream, one MultiheadAttention layer runs with
query = patch and key/value = HFC, then a post-norm FFN and a 1x1 conv back
to the ViT width. Parameters keep the reference's layouts: 1x1 Conv2d
weights, the packed MHA in_proj, and an NCHW (1, C, G, G) pos_embed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cross_attention import cross_attention_packed
from ..parallel.tensor_parallel import copy_to_model
from .common import LayerNorm, Linear, conv1x1, dropout


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention semantics (packed in_proj, out_proj,
    scale = head_dim^-0.5, dropout on the attention weights), batch-first.
    With use_flash, the deterministic (or dropout-free) path runs the
    cross-attention kernel (K4).

    Split over the model axis (parallel/mesh.py::shard_model: `group`,
    `shard` = (ranks, rank)), in_proj holds this rank's heads in each of
    its thirds (`num_heads` and `width` are this rank's), the kernel runs
    on them, and out_proj is the matching row split. The dropout mask of
    every head is drawn, as one process draws it, and this rank's heads'
    slice kept."""

    group = None
    shard = None

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 use_flash: bool = False):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_flash = use_flash
        self.width = dim              # this rank's q (k, v) width
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def tp_width(self) -> int:
        """What a model axis must divide to split the layer: its heads."""
        return self.num_heads

    def tp_split(self, group, ranks: int, rank: int) -> None:
        """Run as this rank's heads (parallel/mesh.py::shard_model)."""
        self.num_heads //= ranks
        self.width //= ranks
        self.group, self.shard = group, (ranks, rank)
        self.out_proj.split, self.out_proj.group = "row", group

    def forward(self, query, key, value, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        b, nq, _ = query.shape
        nk = key.shape[1]
        e, heads = self.width, self.num_heads
        hd = e // heads
        dt = query.dtype
        if self.group is not None:
            same_k, same_v = key is query, value is key
            query = copy_to_model(query, self.group)
            key = query if same_k else copy_to_model(key, self.group)
            value = key if same_v else copy_to_model(value, self.group)
        w = self.in_proj_weight.to(dt)
        bias = self.in_proj_bias.to(dt)
        q = F.linear(query, w[:e], bias[:e])
        k = F.linear(key, w[e:2 * e], bias[e:2 * e])
        v = F.linear(value, w[2 * e:], bias[2 * e:])

        if self.use_flash and (self.dropout == 0.0 or deterministic):
            out = cross_attention_packed(q, k, v, hd ** -0.5, heads)
            return self.out_proj(out)

        q = q.reshape(b, nq, heads, hd).transpose(1, 2)
        k = k.reshape(b, nk, heads, hd).transpose(1, 2)
        v = v.reshape(b, nk, heads, hd).transpose(1, 2)
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        attn = torch.softmax(attn, dim=-1).to(dt)
        attn = dropout(attn, self.dropout, deterministic, generator,
                       None if self.shard is None else (1, *self.shard))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, nq, e)
        return self.out_proj(out)


class CrossAttentionHfcPatch(nn.Module):
    """The adaptor. Split over the model axis, linear1 and linear2 are a
    column and row pair over ffn_dim (`shard` = (ranks, rank)), the
    dropout between them drawn whole and sliced as in MultiheadAttention."""

    shard = None

    def __init__(self, d_model: int = 768, hfc_dim: int = 1024,
                 proj_dim: int = 1024, num_heads: int = 8,
                 ffn_dim: int = 1024, dropout: float = 0.1,
                 grid_size: int = 64, use_flash: bool = False,
                 compat_scrambled_reshape: bool = True):
        super().__init__()
        self.ffn_dim = ffn_dim
        self.proj_dim = proj_dim
        self.dropout = dropout
        # The reference reinterprets the (B, HW, F) tokens as (B, F, H, W)
        # without a transpose before proj_back (image_encoder.py:512); the
        # released weights were trained through this scramble.
        self.compat_scrambled_reshape = compat_scrambled_reshape
        self.pos_embed = nn.Parameter(
            torch.zeros(1, proj_dim, grid_size, grid_size))
        self.proj_hfc = nn.Conv2d(hfc_dim, proj_dim, 1)
        self.proj_patch = nn.Conv2d(d_model, proj_dim, 1)
        self.cross_attn = MultiheadAttention(proj_dim, num_heads, dropout,
                                             use_flash)
        self.norm1 = LayerNorm(proj_dim)
        self.linear1 = Linear(proj_dim, ffn_dim)
        self.linear2 = Linear(ffn_dim, ffn_dim)
        self.norm2 = LayerNorm(ffn_dim)
        self.proj_back = nn.Conv2d(ffn_dim, d_model, 1)

    def tp_width(self) -> int:
        """What a model axis must divide to split linear1 / linear2: the
        hidden width."""
        return self.ffn_dim

    def tp_split(self, group, ranks: int, rank: int) -> None:
        """Run as this rank's slice of the FFN's hidden width."""
        self.shard = (ranks, rank)
        self.linear1.split, self.linear1.group = "column", group
        self.linear2.split, self.linear2.group = "row", group

    def forward(self, hfc_embed: torch.Tensor, patch_embed: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """hfc_embed (B, G, G, hfc_dim), patch_embed (B, G, G, d_model) ->
        (B, G, G, d_model), to be added residually by the caller."""
        b, g = hfc_embed.shape[0], hfc_embed.shape[1]
        dt = patch_embed.dtype

        def drop(t):
            return dropout(t, self.dropout, deterministic, generator)

        pos = self.pos_embed[:, :, :g, :g].permute(0, 2, 3, 1).to(dt)
        hfc = conv1x1(self.proj_hfc, hfc_embed) + pos
        patch = conv1x1(self.proj_patch, patch_embed)
        hfc = hfc.reshape(b, g * g, self.proj_dim)
        patch = patch.reshape(b, g * g, self.proj_dim)

        src2 = self.cross_attn(patch, hfc, hfc, deterministic=deterministic,
                               generator=generator)
        patch = self.norm1(patch + drop(src2))
        # FFN with the reference's residual order (image_encoder.py:506-509).
        h = F.relu(self.linear1(patch))
        h = dropout(h, self.dropout, deterministic, generator,
                    None if self.shard is None else (2, *self.shard))
        y = self.linear2(h)
        out = self.norm2(y + drop(patch))

        if self.compat_scrambled_reshape:
            out = out.reshape(b, self.ffn_dim, g, g).permute(0, 2, 3, 1)
        else:
            out = out.reshape(b, g, g, self.ffn_dim)
        return conv1x1(self.proj_back, out)
