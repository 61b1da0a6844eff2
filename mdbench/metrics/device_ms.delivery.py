"""device_ms.delivery (ms a step): device time of the force delivery (deliver:
the Fj stack and index_add_); the device time that stages.py charges to
stages.DEVICE_LAYERS["delivery"] in its profiled stretch, over the stretch's
md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "device",
                              stages.DEVICE_LAYERS["delivery"])
