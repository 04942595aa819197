"""The numbers that decide `correct`, and the verdict against the limits.

Training, over the checked steps (each number the worst of what it covers):
  loss_gap     |loss - loss_ref| / |loss_ref| of the first step, whose
               weights, batch and dropout draws are the reference's own (the
               later steps start from states that bf16 rounding has already
               moved apart);
  score_gap    the first step's forward: the widest gap of the detection
               scores (the softmax's largest real class) over the batch;
  box_gap_px   and of its boxes, in pixels of the canvas;
  row_grad_gap the first loss's gradient with respect to each image's
               outputs (logits, boxes): | |g_i| - |g_ref_i| | / max(|g_ref_i|,
               the median image's |g_ref|), the worst image and output. An
               image that the loss leaves out reads 1, and so does one whose
               share the loss doubles;
  grad_gap     over the trainable leaves, | |g| - |g_ref| | / max(|g_ref|,
               the median leaf's |g_ref|), g the first step's gradient as
               the optimizer received it (after the clip);
  grad_diff    the median leaf's |g - g_ref| / max(|g_ref|, the median
               leaf's |g_ref|): the gradient's direction as well as its size;
  update_gap   the gap of norms of each leaf's change over the steps, over
               the leaves whose reference gradient is at least a thousandth
               of the median leaf's (a leaf whose gradient is nought to
               rounding moves under Adam by round-off alone).
A leaf the reference trains and the other side does not is read as not
moved and not differentiated. A cell's limits name the numbers it compares.

Serving numbers are the serve_tiles kind's own (score_gap, box_gap_px,
nms_mismatch). Both kinds also give `images_compared`, the images (tiles)
whose outputs were compared: a verdict over none is not correct.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

GRAD_FLOOR = 1e-3
CANVAS_PX = 1024


def _norms(d: Dict[str, torch.Tensor], names) -> Dict[str, float]:
    return {n: float(d[n].double().norm()) if n in d else 0.0 for n in names}


def _gaps(got: Dict[str, float], want: Dict[str, float],
          names: Sequence[str]) -> Dict[str, float]:
    med = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in names}


def row_grad_gap(got: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor]) -> float:
    """The worst image's gap of norms of the loss's gradient with respect
    to its outputs; got / want map an output's name to its (B, ...)
    gradient, want the reference's. An output the program's loss did not
    reach reads as a gradient of zeros."""
    worst = 0.0
    for k, w in want.items():
        w_rows = w.double().flatten(1).norm(dim=1)
        g = got.get(k)
        g_rows = (g.double().flatten(1).norm(dim=1) if g is not None
                  else torch.zeros_like(w_rows))
        floor = max(float(w_rows.median()), 1e-30)
        gap = (g_rows - w_rows).abs() / w_rows.clamp(min=floor)
        worst = max(worst, float(gap.max()))
    return worst


def training_numbers(got: Tuple, want: Tuple, detail: bool = False
                     ) -> Dict[str, float]:
    """got / want: (losses, first gradient, parameters before, after, the
    first step's outputs, the first loss's gradient with respect to them),
    gradient and parameters by leaf name, outputs by their name; want is
    the reference's. With `detail` also each step's loss gap and the worst
    leaves."""
    g_loss, g_grad, g_before, g_after, g_out, g_rows = got
    w_loss, w_grad, w_before, w_after, w_out, w_rows = want
    names = list(w_grad)
    steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(g_loss, w_loss)]
    w_g = _norms(w_grad, names)
    med = statistics.median(w_g.values())
    grads = _gaps(_norms(g_grad, names), w_g, names)
    diff = {n: float((g_grad[n].double() - w_grad[n].double()).norm())
            / max(w_g[n], med, 1e-30) if n in g_grad else 1.0 for n in names}
    moved = [n for n in names if w_g[n] >= GRAD_FLOOR * med]

    def change(after, before):
        return {n: after[n] - before[n] for n in moved
                if n in after and n in before}

    updates = _gaps(_norms(change(g_after, g_before), moved),
                    _norms(change(w_after, w_before), moved), moved)

    def scores(out):
        return torch.softmax(out["pred_logits"], -1)[..., :-1].amax(-1)

    out = {"loss_gap": steps[0],
           "score_gap": float((scores(g_out) - scores(w_out)).abs().max()),
           "box_gap_px": float((g_out["pred_boxes"] - w_out["pred_boxes"])
                               .abs().max()) * CANVAS_PX,
           "row_grad_gap": row_grad_gap(g_rows, w_rows),
           "images_compared": int(w_out["pred_logits"].shape[0]),
           "grad_gap": max(grads.values()),
           "grad_diff": statistics.median(diff.values()),
           "update_gap": max(updates.values())}
    if detail:
        def worst(d):
            return sorted(d.items(), key=lambda x: -x[1])[:4]
        out.update(loss_by_step=steps, grad_worst=worst(grads),
                   update_worst=worst(updates))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[dict]]:
    """(every number within its limit and something compared, the numbers
    beside their limits). A number that is not finite fails."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        good = value == value and value <= limit
        ok = ok and good
        rows.append({"name": name, "value": value, "limit": limit})
    seen = numbers.get("images_compared", 0)
    ok = ok and seen >= 1
    rows.append({"name": "images_compared", "value": seen,
                 "limit": "at least 1"})
    return ok, rows
