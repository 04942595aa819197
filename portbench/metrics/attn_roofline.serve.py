"""The ViT blocks' attention calls' summed bound (harness/counts.py) over the
device time of the kernels under the wm:: attention operators, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.attention_roofline(ctx, "serve")
