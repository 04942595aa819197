"""The share of the traced serving window that the union of the device
operations' intervals leaves uncovered, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.device_idle(ctx, "serve")
