"""The ViT blocks' MLP both ways: the calls' summed bounds over the device time
under wm::fused_mlp and _FusedMlpFn's backward node, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.mlp_roofline(ctx, "train")
