"""Query-based detection decoder (counterpart of
wildlifemapper_tpu/models/decoder.py; reference transformer.py:16-240 and
box_decoder.py:16-149): 51 learned query tokens run against the image
embedding plus the dense PE, then MLP heads emit (B, 51, 8) class logits and
(B, 51, 4) sigmoid cxcywh boxes. LayerNorm eps is 1e-6, as in the JAX
package (ROADMAP queue 3 records the divergence from torch's 1e-5)."""

from __future__ import annotations

import torch
import torch.nn as nn

from .common import LayerNorm, Linear, MLPBlock, MLPHead


class DownsampleAttention(nn.Module):
    """Separate q/k/v projections with internal-dim downsampling
    (reference transformer.py:185-240). Scales after QK.

    Split over the model axis (parallel/mesh.py::shard_model), q_proj,
    k_proj and v_proj are column splits by whole heads and out_proj the
    row split; `num_heads` and `internal` are then this rank's."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.internal = internal
        self.q_proj = Linear(embedding_dim, internal)
        self.k_proj = Linear(embedding_dim, internal)
        self.v_proj = Linear(embedding_dim, internal)
        self.out_proj = Linear(internal, embedding_dim)

    def tp_width(self) -> int:
        """What a model axis must divide to split the layer: its heads."""
        return self.num_heads

    def tp_split(self, group, ranks: int, rank: int) -> None:
        """Run as this rank's heads (parallel/mesh.py::shard_model)."""
        self.num_heads //= ranks
        self.internal //= ranks
        for proj in (self.q_proj, self.k_proj, self.v_proj):
            proj.split, proj.group = "column", group
        self.out_proj.split, self.out_proj.group = "row", group

    def forward(self, q, k, v):
        heads, internal = self.num_heads, self.internal
        hd = internal // heads
        b, nq, _ = q.shape
        nk = k.shape[1]
        q = self.q_proj(q).reshape(b, nq, heads, hd).transpose(1, 2)
        k = self.k_proj(k).reshape(b, nk, heads, hd).transpose(1, 2)
        v = self.v_proj(v).reshape(b, nk, heads, hd).transpose(1, 2)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (hd ** 0.5)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, nq, internal)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    """Query self-attn -> token-to-image attn -> MLP -> image-to-token attn
    (reference transformer.py:109-182)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampleAttention(embedding_dim, num_heads)
        self.norm1 = LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = DownsampleAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = LayerNorm(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, act="relu")
        self.norm3 = LayerNorm(embedding_dim)
        self.norm4 = LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = DownsampleAttention(
            embedding_dim, num_heads, attention_downsample_rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """(reference transformer.py:16-106)"""

    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = DownsampleAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding,
                return_intermediate: bool = False):
        """(B, N, C) image tokens and PE, (B, Nq, C) queries -> (queries,
        keys), plus the per-layer query states with return_intermediate."""
        queries, keys = point_embedding, image_embedding
        intermediate = []
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
            if return_intermediate:
                intermediate.append(queries)
        q = queries + point_embedding
        k = keys + image_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        if return_intermediate:
            return queries, keys, intermediate
        return queries, keys


class BoxDecoder(nn.Module):
    """51-query DETR-style detection head (reference box_decoder.py:16-149).
    The reference's vestigial `iou_token` is not kept; the weight loader
    drops it."""

    def __init__(self, transformer_dim: int = 256, num_queries: int = 51,
                 num_logits: int = 8, head_hidden_dim: int = 256,
                 head_depth: int = 3, depth: int = 2, num_heads: int = 8,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 aux_loss: bool = False):
        super().__init__()
        self.aux_loss = aux_loss
        self.transformer = TwoWayTransformer(
            depth, transformer_dim, num_heads, mlp_dim,
            attention_downsample_rate)
        self.mask_tokens = nn.Embedding(num_queries, transformer_dim)
        self.class_embed = MLPHead(transformer_dim, head_hidden_dim,
                                   num_logits, head_depth)
        self.bbox_embed = MLPHead(transformer_dim, head_hidden_dim, 4,
                                  head_depth, sigmoid_output=True)

    def forward(self, image_embeddings: torch.Tensor,
                image_pe: torch.Tensor) -> dict:
        """image_embeddings (B, G, G, C), image_pe (G, G, C) ->
        dict(pred_logits (B, Nq, L), pred_boxes (B, Nq, 4))."""
        b, g, _, c = image_embeddings.shape
        dt = image_embeddings.dtype
        tokens = self.mask_tokens.weight.to(dt)[None].expand(b, -1, -1)
        src = image_embeddings.reshape(b, g * g, c)
        pe = image_pe.reshape(1, g * g, c).to(dt).expand(b, -1, -1)
        if self.aux_loss:
            hs, _, inter = self.transformer(src, pe, tokens,
                                            return_intermediate=True)
            out = {"pred_logits": self.class_embed(hs),
                   "pred_boxes": self.bbox_embed(hs)}
            out["aux_outputs"] = [
                {"pred_logits": self.class_embed(h),
                 "pred_boxes": self.bbox_embed(h)} for h in inter[:-1]]
            return out
        hs, _ = self.transformer(src, pe, tokens)
        return {"pred_logits": self.class_embed(hs),
                "pred_boxes": self.bbox_embed(hs)}
