"""Batched linear-sum-assignment (Hungarian matching); counterpart of
wildlifemapper_tpu/ops/lsap.py.

The JAX package solves the square LSAP inside the jitted step with a
Jonker-Volgenant loop of ~8000 data-dependent iterations of tiny vector ops.
Eager PyTorch would pay a handful of kernel launches for each of them, so
the port does what the PyTorch original does (matcher.py:77-80): one copy of
the whole (B, S, S) cost to the host and scipy's C++ Jonker-Volgenant per
image. That copy is the one host synchronisation of a train step; it lies
in the criterion, never in the model's forward. The assignment goes back
from page-locked memory without waiting for the device.

`matching_cost_pad` embeds the rectangular DETR problem (Q queries x T
targets) in a square one exactly as the JAX package does, so the two solvers
see the same matrix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def solve_lsap(cost: torch.Tensor, n_rows: Optional[int] = None
               ) -> torch.Tensor:
    """Batched square LSAP. cost (B, n, n) -> row_to_col (B, n) int64 on
    cost's device, the optimal column of each row. No gradient flows
    through the assignment.

    Non-finite entries are sanitised first (NaN and +inf to 1e9, -inf to
    -1e9), as the JAX solver does, so a transient overflow upstream yields
    some assignment and the caller's non-finite-loss guard fires; scipy
    alone would raise.

    n_rows (shared across the batch) solves only rows [0, n_rows): the
    result is optimal for that row subset against all columns. The
    remaining rows are unspecified in the JAX package; here they take the
    columns left over, in order, so each result is a permutation.

    The whole batch crosses to the host in one copy, which waits for the
    device; the per-image solves work on slices of that copy, and the
    result returns to a CUDA device from page-locked memory without a
    second wait.
    """
    from scipy.optimize import linear_sum_assignment

    b, n, n2 = cost.shape
    if n != n2:
        raise ValueError(f"cost must be (B, n, n), got {tuple(cost.shape)}")
    k = n if n_rows is None else max(0, min(int(n_rows), n))
    host = torch.nan_to_num(cost.detach().float(), nan=1e9, posinf=1e9,
                            neginf=-1e9).cpu().numpy()
    out = np.empty((b, n), np.int64)
    for i in range(b):
        rows, cols = linear_sum_assignment(host[i, :k])
        out[i, rows] = cols
        if k < n:
            free = np.ones(n, bool)
            free[cols] = False
            out[i, k:] = np.flatnonzero(free)
    res = torch.from_numpy(out)
    if cost.is_cuda:
        return res.pin_memory().to(cost.device, non_blocking=True)
    return res


def matching_cost_pad(cost: torch.Tensor, target_valid: torch.Tensor,
                      big: float = 100.0) -> torch.Tensor:
    """Embed a (B, Q, T) rectangular DETR cost into a (B, S, S) square one,
    S = max(Q, T):

      real row  x real col  -> cost
      real row  x dummy col -> 0
      dummy row x real col  -> +big   (forces real targets onto real queries)
      dummy row x dummy col -> 0

    Real columns are the valid target slots. `big` must exceed the DETR
    cost range (< 28) but stay small in f32 terms: 100 keeps the solver's
    resolution near 1e-5 when more targets than queries put some of them
    on +big entries (the JAX package measured 1e6 to lose 0.06 of cost).
    """
    b, q, t = cost.shape
    s = max(q, t)
    padded = cost.new_zeros((b, s, s))
    padded[:, :q, :t] = torch.where(target_valid[:, None, :], cost,
                                    cost.new_zeros(()))
    padded[:, q:, :t] = torch.where(target_valid[:, None, :],
                                    cost.new_full((), float(big)),
                                    cost.new_zeros(()))
    return padded
