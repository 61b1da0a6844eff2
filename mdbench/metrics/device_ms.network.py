"""device_ms.network (ms a step): device time of the network: the MLP, its VJP
and the harmonic coefficient glue of the evaluators' _eval_fj; the device
time that stages.py charges to stages.DEVICE_LAYERS["network"] in its
profiled stretch, over the stretch's md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "device",
                              stages.DEVICE_LAYERS["network"])
