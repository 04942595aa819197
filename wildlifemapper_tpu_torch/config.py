"""Typed configuration for the PyTorch port of WildlifeMapper.

A copy of the dataclasses of `wildlifemapper_tpu/config.py`, field for field
with the same defaults, and its JSON persistence (`config_to_json` /
`config_from_json`). One difference: `DataConfig.coco_path` defaults to the
port's own copy of the annotation bundle. The JAX package's config imports
`jax.numpy`, so the port cannot import it on a machine without JAX; the two
copies are held equal by tests/test_torch_ops.py, and a config.json written
by either package loads in the other, mesh included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .data.coco import ASSETS_DIR


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
    # Attention kernel layout (only with use_flash_attention):
    #   "packed"  - the windowed and global kernels (K1, K2) consume the
    #               packed (.., N, 3C) qkv GEMM output and split the heads
    #               themselves; every block's MLP is the fused kernel (K3).
    #   "grouped" - per-(window-)head (B*heads, N, hd) operands, the
    #               reference-shaped data flow with its 5-D transpose, through
    #               the grouped kernels (K6 windowed, K5 global); plain MLP.
    attn_impl: str = "packed"
    # Content crop: run the prologue on the full canvas, then crop the
    # token grid to content_size / patch_size for blocks, neck and decoder.
    content_size: Optional[int] = None
    # Crop the pixels before the prologue too (from-scratch configuration).
    crop_prologue: bool = False
    # Rematerialise each ViT block in the backward pass: two checkpoint
    # segments a block (models/vit.py::Block) that keep the block's input and
    # its attention output; the backward recomputes the rest, all but the
    # fused MLP's forward kernel. No effect on inference.
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
class MatchCriterionConfig:
    """Hungarian matching + DETR set-criterion weights
    (reference: train.py:62-101, build_sam.py:326-331)."""

    set_cost_class: float = 1.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    ce_loss_coef: float = 3.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    eos_coef: float = 0.1
    # Static padded target count per image (the bundled train split peaks
    # at 118 boxes an image).
    max_targets: int = 128


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + preprocessing (reference: dataloader_coco.py, augmentation.py,
    misc.py:46-67)."""

    # The vendored Mara-Wildlife / HerdNet bundle (data/coco.py).
    coco_path: str = str(ASSETS_DIR)
    image_root: str = ""          # directory containing train/ and val/ images
    resize_size: int = 768        # RandomResize([768], max_size=768)
    canvas_size: int = 1024       # zero-pad canvas (misc.py:50)
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    flip_prob: float = 0.5        # train-only FlipLR(0.5)
    # The reference's FlipLR flips H of a CHW tensor (a vertical flip) while
    # updating cy (augmentation.py:265-285). True replicates that.
    flip_is_vertical: bool = True
    # The reference's 4-image mosaic path is dead code
    # (dataloader_coco.py:34). Off by default for parity.
    use_mosaic: bool = False
    # Fixed padded target count per image. None sizes it from the annotation
    # file's densest image, so no ground truth is dropped; an explicit cap
    # that undersizes the dataset is an error unless allow_truncation.
    max_targets: Optional[int] = None
    allow_truncation: bool = False
    batch_size: int = 6
    num_workers: int = 2
    # "thread" or "process" (a spawned worker pool, data/loader.py).
    worker_mode: str = "thread"
    # Ship uint8 canvases and normalise inside the step.
    device_normalize: bool = False
    synthetic: bool = False       # generate tiles when images are absent
    # Render synthetic tiles at this size instead of the annotation file's
    # recorded dims (annotations are rescaled to match).
    synthetic_size: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation schedule (reference: train.py:62-101, 215-222)."""

    lr: float = 1e-4
    hfc_lr: float = 1e-4          # second param group
    weight_decay: float = 1e-3
    epochs: int = 550
    lr_drop: int = 40             # StepLR step size, in epochs
    lr_drop_factor: float = 0.1
    clip_max_norm: float = 0.1
    seed: int = 42
    checkpoint_every: int = 40
    eval_every: int = 1
    best_every: int = 1
    # Freeze policy (reference network.py:19-34): inside the encoder only
    # hfc_embed / hfc_attn / patch_embed train; the decoder fully trains;
    # the dense-PE gaussian matrix never trains.
    freeze_encoder: bool = True
    use_amp: bool = False         # bf16 compute in the train step
    warmup_steps: int = 0         # linear LR warm-up from 0
    ema_decay: float = 0.0        # EMA of the parameters (0 = off)
    log_histograms_every: int = 0
    best_metric: str = "train_loss"


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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. data = batch sharding (DP), model = tensor
    sharding of attention heads / MLP hidden dims (TP; the port refuses a
    model axis above 1, parallel/mesh.py)."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    criterion: MatchCriterionConfig = MatchCriterionConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    eval: EvalConfig = EvalConfig()
    mesh: MeshConfig = MeshConfig()


def model_config(variant: str = "vit_b", **overrides) -> ModelConfig:
    """Build a ModelConfig for a registry variant ('vit_b'|'vit_l'|'vit_h')."""
    vit = VIT_REGISTRY[variant]
    return dataclasses.replace(ModelConfig(vit=vit), **overrides)


# ---- persistence -----------------------------------------------------------
# The exact Config is written beside the checkpoints (train/loop.py), so a
# run is reconstructed at evaluation without its flags.

def config_to_json(cfg: Config) -> str:
    import json

    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def _from_dict(cls, d):
    # Nested dataclass types come from the field defaults (every nested
    # config field has one); keys the class does not know are ignored.
    defaults = cls()
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        default = getattr(defaults, f.name)
        if dataclasses.is_dataclass(default) and isinstance(v, dict):
            v = _from_dict(type(default), v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_json(text: str) -> Config:
    import json

    return _from_dict(Config, json.loads(text))
