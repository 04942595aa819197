"""Device milliseconds a serving batch spends in postprocess and NMS: the
kernels launched under the harness's ranges around eval/postprocess.py's
postprocess and batched_nms."""

from portbench.harness import readers


def read(ctx):
    return readers.device_ms_per_unit(
        ctx, "serve", readers.op_named(("portbench::postprocess",
                                        "portbench::nms")))
