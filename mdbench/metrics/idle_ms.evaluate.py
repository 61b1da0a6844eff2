"""idle_ms.evaluate (ms a step): the device's idle gaps in stages.py's profiled
stretch whose middle the host spent inside a span of
stages.IDLE_LAYERS["evaluate"] (the innermost span open; not in the profiler's
own work), over the stretch's md.steps."""
from mdbench import stages


def read(ctx):
    return stages.per_step_ms(ctx, "idle",
                              stages.IDLE_LAYERS["evaluate"])
