"""DETR-style set criterion with Hungarian matching; counterpart of
wildlifemapper_tpu/train/criterion.py.

  * HungarianMatcher cost = 5*L1 + 1*(-prob[target]) + 2*(-GIoU)
    (reference matcher.py:54-81, weights from train.py:72-77).
  * SetCriterion CE/L1/GIoU losses + cardinality + class_error
    (reference build_sam.py:62-210).

Fixed shapes, as in the JAX package: targets arrive padded to `max_targets`
per image with a validity mask, and the rectangular matching problem is
embedded in a square LSAP (ops/lsap.py). The cost matrices are built on the
device, cross to the host in one copy per call (scipy solves them there),
and the assignment comes back as an index tensor; everything else stays on
the device, and that copy is the only point where a call waits for it. Losses are f32, on the model's `.float()` outputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..config import MatchCriterionConfig
from ..ops import boxes as box_ops
from ..ops.lsap import matching_cost_pad, solve_lsap
from ..parallel.distributed import all_reduce_sum, sum_of_shares


@torch.no_grad()
def hungarian_match(outputs: Dict[str, torch.Tensor],
                    targets: Dict[str, torch.Tensor],
                    cfg: MatchCriterionConfig):
    """The optimal query -> target assignment.

    outputs: pred_logits (B, Q, L), pred_boxes (B, Q, 4) cxcywh in [0, 1].
    targets: labels (B, T) int, boxes (B, T, 4) cxcywh, valid (B, T) bool.

    Returns match_cols (B, Q) int64, the target slot matched to each query
    (meaningful only where matched), and matched (B, Q) bool, the query is
    matched to a valid target.
    """
    logits = outputs["pred_logits"].detach().float()
    pboxes = outputs["pred_boxes"].detach().float()
    b, q, _ = logits.shape
    labels = targets["labels"].long()
    tboxes = targets["boxes"].float()
    valid = targets["valid"].bool()
    t = labels.shape[1]

    prob = torch.softmax(logits, dim=-1)                        # (B, Q, L)
    cost_class = -torch.gather(prob, 2, labels[:, None, :].expand(b, q, t))
    cost_bbox = (pboxes[:, :, None, :] - tboxes[:, None, :, :]).abs().sum(-1)
    cost_giou = -box_ops.generalized_box_iou_pairwise(
        box_ops.box_cxcywh_to_xyxy(pboxes),
        box_ops.box_cxcywh_to_xyxy(tboxes))                     # (B, Q, T)
    cost = (cfg.set_cost_bbox * cost_bbox + cfg.set_cost_class * cost_class
            + cfg.set_cost_giou * cost_giou)
    # Rows = target slots (the transposed square), as the JAX package
    # solves it; invalid slots are all-zero rows whose assignment is never
    # read.
    square = matching_cost_pad(cost, valid).transpose(1, 2)
    t2q = solve_lsap(square)[:, :t]                             # (B, T)

    # Invert target -> query by a scatter, which needs no count from the
    # device; unmatched and out-of-range targets drop into a spare column.
    # t2q is a permutation, so the kept targets' queries are distinct.
    hit = valid & (t2q < q)
    dest = torch.where(hit, t2q, torch.full_like(t2q, q))       # (B, T)
    slots = torch.arange(t, device=logits.device).expand(b, t)
    match_cols = torch.zeros((b, q + 1), dtype=torch.long,
                             device=logits.device
                             ).scatter_(1, dest, slots)[:, :q]
    matched = torch.zeros((b, q + 1), dtype=torch.bool,
                          device=logits.device
                          ).scatter_(1, dest, hit)[:, :q]
    return match_cols, matched


def set_criterion(outputs: Dict[str, torch.Tensor],
                  targets: Dict[str, torch.Tensor],
                  cfg: MatchCriterionConfig, num_classes: int = 7,
                  row_valid: Optional[torch.Tensor] = None,
                  global_batch: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """All losses: loss_ce / loss_bbox / loss_giou (weighted into 'loss')
    plus the logging metrics class_error, cardinality_error and num_boxes.

    row_valid: optional (B,) bool, the batch rows that are real examples
    (the eval loader pads the final batch by repeating the last example).
    Masking padded rows out of every sum and normaliser makes the
    fixed-shape losses equal to evaluating the unpadded batch. None means
    all rows are real.

    global_batch: the step runs over the data axis (parallel/mesh.py): the
    batch is the global one and each rank holds its own rows, as the JAX
    step computes it over its mesh: the normalisers (the box count, the CE
    weight sum) and the logging counts are summed over the ranks, each
    rank's losses are its rows' share of the global ones, and the losses
    returned are their sums over the ranks, identical on every rank. Their
    backward gives each rank world_size times its share's gradient, which
    DistributedDataParallel's mean over the ranks turns into the gradient of
    the global loss. Nothing here waits for the host.
    """
    logits = outputs["pred_logits"]
    num_logits = logits.shape[-1]
    if num_classes != num_logits - 1:
        raise ValueError(
            f"pred_logits has {num_logits} classes but the criterion got "
            f"num_classes={num_classes}; the no-object slot must be the "
            "last logit (num_logits == num_classes + 1)")

    valid = targets["valid"].bool()
    if row_valid is not None:
        row_valid = row_valid.bool()
        valid = valid & row_valid[:, None]
    targets = {"labels": targets["labels"].long(),
               "boxes": targets["boxes"].float(), "valid": valid}

    out = _layer_losses(outputs, targets, cfg, num_classes, row_valid,
                        global_batch)
    # Deep supervision: matching and losses again per intermediate layer.
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        aux_losses = _layer_losses(aux, targets, cfg, num_classes, row_valid,
                                   global_batch)
        out[f"loss_ce_{i}"] = aux_losses["loss_ce"]
        out[f"loss_bbox_{i}"] = aux_losses["loss_bbox"]
        out[f"loss_giou_{i}"] = aux_losses["loss_giou"]
        out["loss"] = out["loss"] + aux_losses["loss"]
    if global_batch:
        keys = [k for k in out if k.startswith("loss")]
        total = sum_of_shares(torch.stack([out[k] for k in keys]))
        out.update(zip(keys, total.unbind()))
    return out


def _layer_losses(outputs: Dict[str, torch.Tensor],
                  targets: Dict[str, torch.Tensor],
                  cfg: MatchCriterionConfig, num_classes: int,
                  row_valid: Optional[torch.Tensor], global_batch: bool
                  ) -> Dict[str, torch.Tensor]:
    """One decoder layer's match and losses; with `global_batch`, this
    rank's shares of the global losses."""
    logits = outputs["pred_logits"].float()                     # (B, Q, L)
    pboxes = outputs["pred_boxes"].float()
    b, q, num_logits = logits.shape
    valid = targets["valid"]
    match_cols, matched = hungarian_match(outputs, targets, cfg)

    # --- classification: weighted CE normalised by the sum of the selected
    # weights (1 for real classes, eos_coef for no-object) ------------------
    tgt_labels = torch.gather(targets["labels"], 1, match_cols)
    target_classes = torch.where(
        matched, tgt_labels, torch.full_like(tgt_labels, num_classes))
    log_prob = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_prob, 2, target_classes[..., None])[..., 0]
    w = torch.where(target_classes == num_classes,
                    logits.new_full((), cfg.eos_coef), logits.new_ones(()))
    if row_valid is not None:
        w = w * row_valid[:, None]

    # class_error: 100 - top-1 accuracy of matched predictions over the real
    # classes (the reference slices off the no-object logit first).
    pred_cls = logits[..., :-1].argmax(-1)
    correct = (pred_cls == tgt_labels) & matched
    # cardinality (logging only)
    card_pred = (logits.argmax(-1) != num_logits - 1).float().sum(1)
    card_abs = (card_pred - valid.float().sum(1)).abs()
    rows = row_valid.float() if row_valid is not None else None

    n_boxes, w_sum = valid.float().sum(), w.sum()
    n_matched, n_correct = matched.float().sum(), correct.float().sum()
    if global_batch:
        # the normalisers and the logging counts over the ranks, in one
        # collective
        if rows is None:
            rows = logits.new_ones(b)
        n_boxes, w_sum, n_matched, n_correct, card_sum, n_rows = \
            all_reduce_sum(torch.stack([
                n_boxes, w_sum, n_matched, n_correct,
                (card_abs * rows).sum(), rows.sum()])).unbind()
        cardinality_error = card_sum / n_rows.clamp(min=1.0)
    elif rows is None:
        cardinality_error = card_abs.mean()
    else:
        cardinality_error = (card_abs * rows).sum() / rows.sum().clamp(min=1.0)
    # the box count for normalisation, clamped to >= 1
    num_boxes = n_boxes.clamp(min=1.0)

    loss_ce = (w * nll).sum() / w_sum.clamp(min=1e-9)
    class_error = 100.0 * (1.0 - n_correct / n_matched.clamp(min=1e-9))

    # --- box losses -----------------------------------------------------------
    tgt_boxes = torch.gather(targets["boxes"], 1,
                             match_cols[..., None].expand(b, q, 4))
    l1 = (pboxes - tgt_boxes).abs().sum(-1)                     # (B, Q)
    zero = logits.new_zeros(())
    loss_bbox = torch.where(matched, l1, zero).sum() / num_boxes
    giou = box_ops.generalized_box_iou_aligned(
        box_ops.box_cxcywh_to_xyxy(pboxes),
        box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    loss_giou = torch.where(matched, 1.0 - giou, zero).sum() / num_boxes

    loss = (cfg.ce_loss_coef * loss_ce + cfg.bbox_loss_coef * loss_bbox
            + cfg.giou_loss_coef * loss_giou)
    return {
        "loss": loss,
        "loss_ce": loss_ce,
        "loss_bbox": loss_bbox,
        "loss_giou": loss_giou,
        "class_error": class_error.detach(),
        "cardinality_error": cardinality_error.detach(),
        "num_boxes": num_boxes,
    }
