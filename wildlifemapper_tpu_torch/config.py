"""Typed configuration for the PyTorch port of WildlifeMapper.

A copy of the model-side dataclasses of `wildlifemapper_tpu/config.py`, with
identical fields and defaults. The JAX package's config imports `jax.numpy`,
so the port cannot import it on a machine without JAX; the two copies are
kept field-for-field equal (tests/test_torch_ops.py checks it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """SAM ViT image-encoder hyperparameters (reference: build_sam.py:19-52, 260-288)."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    mlp_ratio: float = 4.0
    window_size: int = 14
    out_chans: int = 256  # neck output channels (prompt_embed_dim)
    qkv_bias: bool = True
    use_rel_pos: bool = True
    use_abs_pos: bool = True


VIT_B = ViTConfig()
VIT_L = ViTConfig(embed_dim=1024, depth=24, num_heads=16,
                  global_attn_indexes=(5, 11, 17, 23))
VIT_H = ViTConfig(embed_dim=1280, depth=32, num_heads=16,
                  global_attn_indexes=(7, 15, 23, 31))

VIT_REGISTRY = {
    "vit_b": VIT_B,
    "vit_l": VIT_L,
    "vit_h": VIT_H,
    "default": VIT_H,
}


@dataclasses.dataclass(frozen=True)
class HFCConfig:
    """High-frequency-component adaptor (reference: network.py:36-57,
    image_encoder.py:65-87, 452-516)."""

    rate: float = 0.125
    embed_dim: int = 1024
    proj_dim: int = 1024
    num_heads: int = 8
    ffn_dim: int = 1024
    dropout: float = 0.1
    # The reference reinterprets the (B, HW, F) adaptor output as
    # (B, F, H, W) without a transpose before proj_back
    # (image_encoder.py:512); released checkpoints were trained through it.
    compat_scrambled_reshape: bool = True


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """DETR-style detection decoder (reference: build_sam.py:295-306,
    box_decoder.py:16-107, transformer.py:16-60)."""

    transformer_dim: int = 256
    depth: int = 2
    num_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_queries: int = 51
    head_hidden_dim: int = 256
    head_depth: int = 3
    aux_loss: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vit: ViTConfig = VIT_B
    hfc: HFCConfig = HFCConfig()
    decoder: DecoderConfig = DecoderConfig()
    img_size: int = 1024
    patch_size: int = 16
    # 6 real classes with ids 1..6; id 0 unused; index 7 is no-object.
    num_classes: int = 7
    # Compute dtype for the hot path; parameters always live in float32.
    dtype: str = "float32"
    # Route attention and the ViT MLP through the hand-written kernels
    # (plain PyTorch otherwise, on any device).
    use_flash_attention: bool = False
    # Kernel layout (only with use_flash_attention): "packed" is the only
    # one ported; "grouped" raises NotImplementedError.
    attn_impl: str = "packed"
    # Content crop: run the prologue on the full canvas, then crop the
    # token grid to content_size / patch_size for blocks, neck and decoder.
    content_size: Optional[int] = None
    # Crop the pixels before the prologue too (from-scratch configuration).
    crop_prologue: bool = False
    # Kept for field parity with the JAX config; no effect on inference.
    remat_blocks: bool = False

    def __post_init__(self):
        if self.crop_prologue:
            if self.content_size is None:
                raise ValueError("crop_prologue requires content_size")
            if self.hfc.compat_scrambled_reshape:
                raise ValueError(
                    "crop_prologue requires "
                    "hfc.compat_scrambled_reshape=False: the scrambled "
                    "reshape (image_encoder.py:512) mixes tokens across the "
                    "full 64-grid, so the checkpoint-compatible prologue "
                    "must run at the full canvas")

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_logits(self) -> int:
        return self.num_classes + 1

    @property
    def content_grid(self) -> Optional[int]:
        if self.content_size is None:
            return None
        return self.content_size // self.patch_size

    @property
    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Post-processing (reference: build_sam.py:212-258,
    visualize_prediction.py:36,150-157)."""

    confidence_threshold: float = 0.05
    viz_confidence_threshold: float = 0.5
    nms_iou: float = 0.4
    max_detections: int = 51
    # Reference PostProcess swaps h/w when scaling boxes (build_sam.py:252).
    hw_swap_compat: bool = True


def model_config(variant: str = "vit_b", **overrides) -> ModelConfig:
    """Build a ModelConfig for a registry variant ('vit_b'|'vit_l'|'vit_h')."""
    vit = VIT_REGISTRY[variant]
    return dataclasses.replace(ModelConfig(vit=vit), **overrides)
