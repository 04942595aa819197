"""The plain reference of the training objective and update: DETR's
Hungarian matching and set criterion (cost 5 L1 + 1 class + 2 GIoU; loss
3 CE + 5 L1 + 2 GIoU, no-object weight 0.1, normalised by the batch's box
count), the clip of the gradients' global norm, and torch's AdamW, written
out in float32 and NumPy. The assignment is solved here by a shortest
augmenting path in NumPy; nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


HFC_PREFIXES = ("image_encoder.hfc_embed.", "image_encoder.hfc_attn.",
                "image_encoder.patch_embed.")


def trains(name: str, freeze_encoder: bool = True) -> bool:
    """WildlifeMapper's freeze policy: the dense PE's gaussian never trains;
    inside the image encoder only the HFC embedding, the adaptor and the
    patch embedding train unless the encoder trains too; the decoder
    trains."""
    if name.startswith("prompt_encoder."):
        return False
    if name.startswith(HFC_PREFIXES):
        return True
    if name.startswith("image_encoder."):
        return not freeze_encoder
    return True


def lsap(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment of every row of a (n, m) cost, n <= m, to a
    distinct column (the Hungarian method by shortest augmenting paths,
    float64): returns the column of each row."""
    a = np.asarray(cost, np.float64)
    n, m = a.shape
    if n > m:
        raise ValueError("lsap takes no more rows than columns")
    u, v = np.zeros(n + 1), np.zeros(m + 1)
    p = np.zeros(m + 1, np.int64)          # row (1-based) on each column
    way = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        p[0], j0 = i, 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            free = ~used[1:]
            cur = a[i0 - 1] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            cand = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(cand)) + 1
            delta = cand[j1 - 1]
            u[p[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    cols = np.empty(n, np.int64)
    for j in range(1, m + 1):
        if p[j]:
            cols[p[j] - 1] = j - 1
    return cols


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou(a, b):
    """Generalised IoU of aligned xyxy boxes (..., 4) -> (...)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    inter_wh = (torch.minimum(a[..., 2:], b[..., 2:])
                - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = area_a + area_b - inter
    hull_wh = (torch.maximum(a[..., 2:], b[..., 2:])
               - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0)
    hull = hull_wh[..., 0] * hull_wh[..., 1]
    iou = inter / union.clamp(min=1e-9)
    return iou - (hull - union) / hull.clamp(min=1e-9)


@torch.no_grad()
def match(logits, boxes, labels, tboxes, valid, w_bbox=5.0, w_class=1.0,
          w_giou=2.0) -> List[tuple]:
    """Per image, (query indices, target slots) of the optimal assignment
    between the Q queries and the image's valid targets."""
    prob = torch.softmax(logits.float(), -1)
    out = []
    for i in range(logits.shape[0]):
        slots = torch.nonzero(valid[i]).flatten()
        if slots.numel() == 0:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
            continue
        tb, tl = tboxes[i, slots].float(), labels[i, slots]
        pb = boxes[i].float()
        c_class = -prob[i][:, tl]                                # (Q, T)
        c_bbox = (pb[:, None, :] - tb[None, :, :]).abs().sum(-1)
        c_giou = -giou(cxcywh_to_xyxy(pb)[:, None, :],
                       cxcywh_to_xyxy(tb)[None, :, :])
        cost = (w_bbox * c_bbox + w_class * c_class
                + w_giou * c_giou).cpu().numpy()
        q, t = cost.shape
        if t <= q:
            t_idx = np.arange(t)
            q_idx = lsap(cost.T)
        else:
            q_idx = np.arange(q)
            t_idx = lsap(cost)
        out.append((q_idx, slots.cpu().numpy()[t_idx]))
    return out


def set_loss(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             num_classes: int, ce_coef=3.0, bbox_coef=5.0, giou_coef=2.0,
             eos_coef=0.1, rows: slice = slice(None)) -> torch.Tensor:
    """The weighted set loss of the whole batch. `rows` restricts the
    matching and the sums to a slice of the batch, with the normalisers
    taken over that slice (the batch of a step that left rows out)."""
    logits = out["pred_logits"][rows].float()
    boxes = out["pred_boxes"][rows].float()
    labels = batch["labels"][rows].long()
    tboxes = batch["boxes"][rows].float()
    valid = batch["valid"][rows].bool()
    b, q, _ = logits.shape
    pairs = match(logits, boxes, labels, tboxes, valid)
    target = torch.full((b, q), num_classes, dtype=torch.long,
                        device=logits.device)
    l1 = logits.new_zeros(())
    gi = logits.new_zeros(())
    for i, (qi, ti) in enumerate(pairs):
        if len(qi) == 0:
            continue
        qi = torch.as_tensor(qi, device=logits.device)
        ti = torch.as_tensor(ti, device=logits.device)
        target[i, qi] = labels[i, ti]
        pb, tb = boxes[i, qi], tboxes[i, ti]
        l1 = l1 + (pb - tb).abs().sum()
        gi = gi + (1.0 - giou(cxcywh_to_xyxy(pb), cxcywh_to_xyxy(tb))).sum()
    weight = torch.ones(num_classes + 1, device=logits.device)
    weight[num_classes] = eos_coef
    ce = F.cross_entropy(logits.reshape(-1, num_classes + 1),
                         target.reshape(-1), weight=weight)
    n_boxes = valid.float().sum().clamp(min=1.0)
    return ce_coef * ce + bbox_coef * l1 / n_boxes + giou_coef * gi / n_boxes


def clip_global_norm_(grads: Sequence[torch.Tensor], max_norm: float):
    """g <- g * max_norm / |g| when the global norm |g| >= max_norm."""
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads)).float()
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


class AdamW:
    """torch.optim.AdamW's update, decoupled decay first, written out."""

    def __init__(self, params: Sequence[torch.Tensor], lr=1e-4, wd=1e-3,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.wd = list(params), lr, wd
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, (v / c2).sqrt() + self.eps, value=-self.lr / c1)
