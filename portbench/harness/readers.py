"""What the per-layer metric files share: each file under metrics/ is a
`read(ctx)` that calls one of these with its own arguments. A reader that
finds nothing to read returns None, and the metric is left out of the line.

`ctx` (harness/runner.py::LayerContext) carries the traced stretch's
Timeline, the number of batches or steps in it (`units`), the busy and
window seconds of a second stretch that traced the device alone, the
untraced window's seconds per batch or step (`unit_s`), the cell's mode
("serve" or "train") and its operation counts.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from . import counts

ATTENTION_OPS = ("wm::windowed_attention_packed", "wm::flash_attention_packed")
ATTENTION_BACKWARD = ("PackedAttentionFnBackward",)
MLP_OPS = ("wm::fused_mlp",)
MLP_BACKWARD = ("_FusedMlpFnBackward",)
OPTIMIZER = ("Optimizer.step#AdamW.step",)


def op_named(names: Sequence[str]) -> Callable[[str], bool]:
    """A host range that is one of these operators (any overload)."""
    return lambda n: any(n == x or n.startswith(x + ".") for x in names)


def node_named(names: Sequence[str]) -> Callable[[str], bool]:
    """An autograd node's range (it carries the node's name at its end)."""
    return lambda n: any(n.endswith(x) for x in names)


def either(*preds):
    return lambda n: any(p(n) for p in preds)


def device_ms_per_unit(ctx, mode: str, match) -> Optional[float]:
    if ctx.mode != mode or ctx.timeline is None or not ctx.units:
        return None
    sec, n = ctx.timeline.device_time(match)
    return sec / ctx.units * 1e3 if n else None


def mfu(ctx, mode: str) -> Optional[float]:
    """The step's least time at the dtypes' peaks over the measured time of
    a batch or step, in %."""
    if ctx.mode != mode or not ctx.unit_s:
        return None
    return counts.least_seconds(ctx.products) / ctx.unit_s * 100.0


def roofline(ctx, mode: str, bound_per_unit: float, match) -> Optional[float]:
    """Sum of the calls' bounds over the device time of their kernels in
    the traced stretch, in %; None where no kernel ran under them."""
    if ctx.mode != mode or ctx.timeline is None or not ctx.units:
        return None
    sec, n = ctx.timeline.device_time(match)
    if not n or sec <= 0:
        return None
    return bound_per_unit * ctx.units / sec * 100.0


def attention_roofline(ctx, mode: str) -> Optional[float]:
    calls = counts.attention_calls(ctx.spec, ctx.batch)
    train = mode == "train"
    bound = sum(counts.attention_bound(c, lse=train) for c in calls)
    match = op_named(ATTENTION_OPS)
    if train:
        bound += sum(counts.attention_bound(c, backward=True) for c in calls)
        match = either(match, node_named(ATTENTION_BACKWARD))
    return roofline(ctx, mode, bound, match)


def mlp_roofline(ctx, mode: str) -> Optional[float]:
    calls = counts.mlp_calls(ctx.spec, ctx.batch)
    bound = sum(counts.mlp_bound(c) for c in calls)
    match = op_named(MLP_OPS)
    if mode == "train":
        bound += sum(counts.mlp_bound(c, backward=True,
                                      weights_train=ctx.encoder_trains)
                     for c in calls)
        match = either(match, node_named(MLP_BACKWARD))
    return roofline(ctx, mode, bound, match)


def device_idle(ctx, mode: str) -> Optional[float]:
    """The share of the device-only traced stretch that the union of the
    device operations' intervals leaves uncovered."""
    if ctx.mode != mode or ctx.window_s <= 0:
        return None
    return (1.0 - ctx.busy_s / ctx.window_s) * 100.0
