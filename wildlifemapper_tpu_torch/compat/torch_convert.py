"""The reference's PyTorch checkpoints into the port's model; counterpart of
wildlifemapper_tpu/compat/torch_convert.py.

Handles both checkpoint flavors the reference uses:

  * Raw SAM weights (`sam_vit_b_01ec64.pth`): keys like
    `image_encoder.blocks.0.attn.qkv.weight`. The reference performs
    "checkpoint surgery" before loading — every `mask_decoder.*` param except
    those containing `transformer` is deleted, then `load_state_dict(
    strict=False)` (build_sam.py:311-322). We reproduce that: loaded keys
    overwrite the model's values; missing keys keep them.
  * Trained WildlifeMapper checkpoints (`train.py:350-354`): a dict with a
    `model` entry whose keys carry a `module.` DDP prefix and the MedSAM
    wrapper's `image_encoder./mask_decoder./prompt_encoder.` names.

The port's parameters carry the reference's names in torch layouts, so no
key map or layout change is needed: the merge (weights.merge_state_dict)
drops the vestigial `mask_decoder.iou_token.weight`, centre-slices rel-pos
tables for a smaller window and refuses any other shape mismatch.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..weights import merge_state_dict


def strip_prefixes(sd: Mapping[str, object]) -> Dict[str, object]:
    """Remove DDP 'module.' prefixes (train.py saves the DDP-wrapped model)."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def apply_sam_surgery(sd: Mapping[str, object]) -> Dict[str, object]:
    """The reference's decoder-head surgery on raw SAM checkpoints
    (build_sam.py:314-320): keep mask_decoder.* only if 'transformer' in key."""
    return {k: v for k, v in sd.items()
            if not (k.startswith("mask_decoder.") and "transformer" not in k)}


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A .pth file's state dict as CPU tensors; a trained checkpoint's
    {model, optimizer, epoch} gives its `model` entry."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {k: v.detach() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.asarray(v)) for k, v in obj.items()}


def convert_checkpoint(path: str, model: nn.Module) -> Dict[str, List[str]]:
    """Full pipeline: read .pth, strip DDP prefixes, SAM surgery on a raw
    SAM file (one with no hfc keys), merge into `model` in place with
    strict=False semantics. Returns {"loaded", "missing", "unexpected"} in
    the port's names; the depth is the model's own."""
    sd = strip_prefixes(load_torch_file(path))
    if not any("hfc" in k for k in sd):
        sd = apply_sam_surgery(sd)
    return merge_state_dict(model, sd)
