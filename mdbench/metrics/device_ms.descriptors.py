"""device_ms.descriptors (ms a step): device time of the descriptor kernels
(g_harm, g_cos, ni_g and their tiled forms); the device time that stages.py
charges to stages.DEVICE_LAYERS["descriptors"] in its profiled stretch, over
the stretch's md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "device",
                              stages.DEVICE_LAYERS["descriptors"])
