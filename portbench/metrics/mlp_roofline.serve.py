"""The ViT blocks' MLP: the calls' summed bound over the device time under
wm::fused_mlp, in %."""

from portbench.harness import readers


def read(ctx):
    return readers.mlp_roofline(ctx, "serve")
