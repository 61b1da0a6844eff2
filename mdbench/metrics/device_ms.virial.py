"""device_ms.virial (ms a step): device time of the pair virial (pair_virial;
steps that are not light); the device time that stages.py charges to
stages.DEVICE_LAYERS["virial"] in its profiled stretch, over the stretch's
md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "device",
                              stages.DEVICE_LAYERS["virial"])
