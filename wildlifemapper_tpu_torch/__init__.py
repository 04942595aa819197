"""PyTorch port of WildlifeMapper for NVIDIA Hopper: the serving forward
pass (HFC -> ViT encoder -> box decoder -> postprocess + NMS), the train
step and the training loop (loader, checkpoints, COCO evaluation, CLIs),
with hand-written CUDA kernels under csrc/. Imports torch and numpy only
(PIL only to decode real image files)."""

__version__ = "0.1.0"

from .config import ModelConfig, model_config  # noqa: F401
