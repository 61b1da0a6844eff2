"""device_ms.driver (ms a step): device time of the MD driver: integrator,
thermo, the block-end read, and the evaluator's own ops outside its stages;
the device time that stages.py charges to stages.DEVICE_LAYERS["driver"] in
its profiled stretch, over the stretch's md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "device",
                              stages.DEVICE_LAYERS["driver"])
