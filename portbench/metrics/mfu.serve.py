"""The serving batch's least time (its products at the dtypes' dense peaks,
harness/counts.py) over its measured time, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, "serve")
