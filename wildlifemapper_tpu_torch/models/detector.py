"""WildlifeMapper top-level detector (counterpart of
wildlifemapper_tpu/models/detector.py; reference MedSAM.forward,
network.py:59-87): HFC map -> HFC-augmented ViT encoder -> box decoder
against the dense random-Fourier PE."""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.hfc import hfc_filter
from .common import LayerNorm
from .decoder import BoxDecoder
from .pos_embed import PositionEmbeddingRandom
from .vit import ImageEncoderViT


# flax.linen.initializers.lecun_normal draws a unit normal truncated to
# [-2, 2] and divides by its standard deviation, this constant (flax's own),
# so that the variance is 1 / fan_in.
LECUN_TRUNCATED_STD = 0.87962566103423978
# Parameters the JAX package initialises to zeros (models/vit.py:136-138,
# 358; models/adaptor.py:105).
ZERO_INIT = ("rel_pos_h", "rel_pos_w", "pos_embed")


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The port's device rule: the card unless the caller asks for the CPU.
    None means torch.device("cuda") and raises if CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on a CUDA GPU by default and "
                "torch.cuda.is_available() is False; pass device=\"cpu\" "
                "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class WildlifeMapper(nn.Module):
    """images NHWC (B, img, img, 3), normalised -> {pred_logits, pred_boxes}.

    Parameter names are the PyTorch reference's state-dict names
    (image_encoder.*, prompt_encoder.pe_layer.*, mask_decoder.*).

    The model is built on the card: `device=None` means
    `torch.device("cuda")` and raises without CUDA; it lives on the CPU only
    when the caller passes `device="cpu"`. Parameters are created on that
    device directly; `generator` may live on either.
    """

    def __init__(self, config: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None,
                 device: Union[None, str, torch.device] = None):
        super().__init__()
        cfg = self.config = config
        with torch.device(resolve_device(device)):
            self._build(cfg)
        self.reset_parameters(generator)

    def _build(self, cfg: ModelConfig) -> None:
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
            hfc_scrambled_reshape=cfg.hfc.compat_scrambled_reshape,
            remat_blocks=cfg.remat_blocks)
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

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Seeded initialisation from the distributions that
        wildlifemapper_tpu.models.WildlifeMapper.init draws each parameter
        from: every Linear and Conv weight from flax's `lecun_normal` (a
        normal truncated at two standard deviations, variance 1 / fan_in,
        fan_in the input width times the kernel's area), biases, the rel-pos
        tables and both absolute position embeddings zero, LayerNorms
        identity, the query tokens and the PE gaussian matrix N(0, 1). The
        numbers come from a torch.Generator, so they differ from JAX's by
        construction; the distributions do not. They are drawn on the
        generator's device and copied to the parameter's, so one seed gives
        one model wherever it lives."""
        def draw(t, sample):
            where = generator.device if generator is not None else t.device
            t.copy_(sample(torch.empty(t.shape, device=where)))

        def lecun_normal(t):
            # (out, in) or (out, in, kh, kw): fan_in is all but the first dim
            std = t[0].numel() ** -0.5 / LECUN_TRUNCATED_STD
            draw(t, lambda e: nn.init.trunc_normal_(
                e, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))

        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
            for name, p in mod.named_parameters(recurse=False):
                if name.endswith("bias") or name in ZERO_INIT:
                    p.zero_()
                else:
                    lecun_normal(p)
        for p in (self.mask_decoder.mask_tokens.weight,
                  self.prompt_encoder["pe_layer"]
                  .positional_encoding_gaussian_matrix):
            draw(p, lambda e: e.normal_(0.0, 1.0, generator=generator))

    def forward(self, images: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        return self.decode(self.encode(images, deterministic=deterministic,
                                       generator=generator))

    def encode(self, images: torch.Tensor, *, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The forward's first half: (crop prologue), HFC map, encoder ->
        the image embedding (B, g, g, out_chans) in the compute dtype."""
        cfg = self.config
        dt = cfg.compute_dtype
        if cfg.crop_prologue and cfg.content_size is not None:
            # From-scratch mode: the whole network, HFC included, runs on
            # the content pixels.
            images = images[:, :cfg.content_size, :cfg.content_size, :]

        # HFC runs in f32, the result is cast to the compute dtype.
        hfc = hfc_filter(images.to(torch.float32), cfg.hfc.rate).to(dt)
        return self.image_encoder(images.to(dt), hfc,
                                  deterministic=deterministic,
                                  generator=generator)

    def decode(self, emb: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The forward's second half: the dense PE (sliced to the content
        grid) and the box decoder on an image embedding -> {pred_logits,
        pred_boxes (, aux_outputs)} in float32."""
        cfg = self.config
        pe = self.prompt_encoder["pe_layer"](cfg.grid_size).to(
            cfg.compute_dtype)
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
