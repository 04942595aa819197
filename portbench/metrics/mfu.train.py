"""The training step's least time (forward, input gradients, the weight
gradients of what trains; no recompute) over its measured time, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, "train")
