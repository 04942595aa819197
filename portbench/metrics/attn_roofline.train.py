"""The ViT blocks' attention both ways: the calls' summed bounds over the
device time under the wm:: attention operators and PackedAttentionFn's
backward node, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.attention_roofline(ctx, "train")
