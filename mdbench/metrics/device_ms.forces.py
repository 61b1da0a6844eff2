"""device_ms.forces (ms a step): device time of the force kernels (force_harm,
force_cos, ni_force and their tiled forms); the device time that stages.py
charges to stages.DEVICE_LAYERS["forces"] in its profiled stretch, over the
stretch's md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "device",
                              stages.DEVICE_LAYERS["forces"])
