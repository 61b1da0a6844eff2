"""device_ms.neighbor (ms a step): device time of the neighbor lists: the
displacement checks, skin-list builds and short-list compactions; the device
time that stages.py charges to stages.DEVICE_LAYERS["neighbor"] in its
profiled stretch, over the stretch's md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "device",
                              stages.DEVICE_LAYERS["neighbor"])
