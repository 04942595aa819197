"""Device milliseconds a step spends in AdamW: the kernels under torch's
Optimizer.step#AdamW.step range."""

from portbench.harness import readers


def read(ctx):
    return readers.device_ms_per_unit(ctx, "train",
                                      readers.op_named(readers.OPTIMIZER))
