"""Optimizer assembly: AdamW param groups, StepLR schedule, freeze policy,
clipping; counterpart of wildlifemapper_tpu/train/optimizer.py.

  * Two AdamW groups at lr 1e-4 / wd 1e-3 (reference train.py:215-222):
    "main" = decoder (+ anything else), "hfc" = hfc_embed / patch_embed /
    hfc_attn.
  * StepLR(step_size=40 epochs, gamma=0.1), counted in optimizer steps, with
    an optional linear warm-up.
  * Freeze policy (reference network.py:19-34): inside the image encoder
    only hfc_embed / hfc_attn / patch_embed train.
  * Gradient clipping by global norm 0.1 over the trainable parameters.

torch.optim.AdamW with eps 1e-8, betas (0.9, 0.999) and decoupled decay
agrees with optax.adamw term by term: p <- p - lr*(m_hat / (sqrt(v_hat) +
eps) + wd*p), with lr read at the count of updates already made.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch
import torch.nn as nn

from ..config import TrainConfig

HFC_PREFIXES = ("image_encoder.hfc_embed.", "image_encoder.hfc_attn.",
                "image_encoder.patch_embed.")


def param_group(name: str, freeze_encoder: bool = True) -> str:
    """'main' | 'hfc' | 'frozen' for one of the port's state-dict names."""
    if name.startswith("prompt_encoder.pe_layer"):
        return "frozen"          # a buffer in the reference
    if name.startswith(HFC_PREFIXES):
        return "hfc"
    if name.startswith("image_encoder."):
        return "frozen" if freeze_encoder else "main"
    return "main"                # box decoder and anything else


def lr_factor(steps_per_epoch: int, lr_drop_epochs: int, factor: float,
              warmup_steps: int = 0) -> Callable[[int], float]:
    """The multiplier of the base lr at update count `step`: a staircase
    factor^(step // (lr_drop_epochs * steps_per_epoch)), after an optional
    linear warm-up from 0 over `warmup_steps` updates at whose end the
    staircase starts counting from 0 (optax.join_schedules)."""
    drop = lr_drop_epochs * steps_per_epoch

    def at(step: int) -> float:
        if warmup_steps > 0:
            if step < warmup_steps:
                return step / warmup_steps
            step -= warmup_steps
        return factor ** (step // drop)

    return at


def apply_freeze(model: nn.Module, freeze_encoder: bool
                 ) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
    """Set requires_grad by the freeze policy, so that autograd skips the
    frozen weights' gradient products while activations still flow to the
    trainable embeddings below them. Returns the named parameters by group
    ('main', 'hfc', 'frozen')."""
    groups = {"main": [], "hfc": [], "frozen": []}
    for name, p in model.named_parameters():
        g = param_group(name, freeze_encoder)
        p.requires_grad_(g != "frozen")
        groups[g].append((name, p))
    return groups


def build_optimizer(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int):
    """(optimizer, scheduler) for the model under cfg's freeze policy. Call
    scheduler.step() once after every optimizer.step()."""
    groups = apply_freeze(model, cfg.freeze_encoder)
    opt = torch.optim.AdamW(
        [{"params": [p for _, p in groups["main"]], "lr": cfg.lr,
          "name": "main"},
         {"params": [p for _, p in groups["hfc"]], "lr": cfg.hfc_lr,
          "name": "hfc"}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lr_factor(steps_per_epoch, cfg.lr_drop, cfg.lr_drop_factor,
                       cfg.warmup_steps))
    return opt, sched


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: gradients are left alone when
    their global norm is below max_norm and otherwise become
    g / norm * max_norm (torch's clip_grad_norm_ divides by norm + 1e-6,
    a 1e-5 relative difference at max_norm 0.1). Returns the norm before
    clipping, without synchronising with the host."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, one * max_norm))
    return norm
