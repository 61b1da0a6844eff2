"""device_ms.gather (ms a step): device time of the pair gather (pair_dx_planes
in evaluate_pairs); the device time that stages.py charges to
stages.DEVICE_LAYERS["gather"] in its profiled stretch, over the stretch's
md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "device",
                              stages.DEVICE_LAYERS["gather"])
