"""WildlifeMapper top-level detector (counterpart of
wildlifemapper_tpu/models/detector.py; reference MedSAM.forward,
network.py:59-87): HFC map -> HFC-augmented ViT encoder -> box decoder
against the dense random-Fourier PE."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.hfc import hfc_filter
from .common import LayerNorm
from .decoder import BoxDecoder
from .pos_embed import PositionEmbeddingRandom
from .vit import ImageEncoderViT


class WildlifeMapper(nn.Module):
    """images NHWC (B, img, img, 3), normalised -> {pred_logits, pred_boxes}.

    Parameter names are the PyTorch reference's state-dict names
    (image_encoder.*, prompt_encoder.pe_layer.*, mask_decoder.*).
    """

    def __init__(self, config: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        self.image_encoder = ImageEncoderViT(
            img_size=cfg.img_size, patch_size=cfg.patch_size,
            embed_dim=cfg.vit.embed_dim, depth=cfg.vit.depth,
            num_heads=cfg.vit.num_heads, mlp_ratio=cfg.vit.mlp_ratio,
            out_chans=cfg.vit.out_chans, qkv_bias=cfg.vit.qkv_bias,
            use_abs_pos=cfg.vit.use_abs_pos, use_rel_pos=cfg.vit.use_rel_pos,
            window_size=cfg.vit.window_size,
            global_attn_indexes=cfg.vit.global_attn_indexes,
            hfc_embed_dim=cfg.hfc.embed_dim, hfc_num_heads=cfg.hfc.num_heads,
            hfc_ffn_dim=cfg.hfc.ffn_dim, hfc_proj_dim=cfg.hfc.proj_dim,
            hfc_dropout=cfg.hfc.dropout, use_flash=cfg.use_flash_attention,
            attn_impl=cfg.attn_impl, content_grid=cfg.content_grid,
            hfc_scrambled_reshape=cfg.hfc.compat_scrambled_reshape)
        self.prompt_encoder = nn.ModuleDict({
            "pe_layer": PositionEmbeddingRandom(
                cfg.decoder.transformer_dim // 2)})
        self.mask_decoder = BoxDecoder(
            transformer_dim=cfg.decoder.transformer_dim,
            num_queries=cfg.decoder.num_queries, num_logits=cfg.num_logits,
            head_hidden_dim=cfg.decoder.head_hidden_dim,
            head_depth=cfg.decoder.head_depth, depth=cfg.decoder.depth,
            num_heads=cfg.decoder.num_heads, mlp_dim=cfg.decoder.mlp_dim,
            attention_downsample_rate=cfg.decoder.attention_downsample_rate,
            aux_loss=cfg.decoder.aux_loss)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Seeded initialisation: weights N(0, 0.02), biases 0, LayerNorms
        identity, query tokens and the PE gaussian matrix N(0, 1)."""
        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
            for name, p in mod.named_parameters(recurse=False):
                if name.endswith("bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=generator)
        self.mask_decoder.mask_tokens.weight.normal_(generator=generator)
        self.prompt_encoder["pe_layer"].positional_encoding_gaussian_matrix \
            .normal_(generator=generator)

    def forward(self, images: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        dt = cfg.compute_dtype
        if cfg.crop_prologue and cfg.content_size is not None:
            # From-scratch mode: the whole network, HFC included, runs on
            # the content pixels.
            images = images[:, :cfg.content_size, :cfg.content_size, :]

        # HFC runs in f32, the result is cast to the compute dtype.
        hfc = hfc_filter(images.to(torch.float32), cfg.hfc.rate).to(dt)
        emb = self.image_encoder(images.to(dt), hfc,
                                 deterministic=deterministic,
                                 generator=generator)

        pe = self.prompt_encoder["pe_layer"](cfg.grid_size).to(dt)
        cg = cfg.content_grid
        if cg is not None and cg < cfg.grid_size:
            pe = pe[:cg, :cg]
        out = self.mask_decoder(emb, pe)

        result = {"pred_logits": out["pred_logits"].float(),
                  "pred_boxes": out["pred_boxes"].float()}
        if "aux_outputs" in out:
            result["aux_outputs"] = [{k: v.float() for k, v in a.items()}
                                     for a in out["aux_outputs"]]
        return result
