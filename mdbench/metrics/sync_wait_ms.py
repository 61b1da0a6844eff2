"""sync_wait_ms (ms a step): host time inside the program's md.stale_read
span (the block-end read of the stale flag, which waits for the card) in
stages.py's stretch with spans on and no profiler, over its md.steps. Near
0: the host sets the pace; near the step's time: the card does."""
from mdbench import stages


def read(ctx):
    r = stages.readings(ctx)
    if r is None or not r.span_steps:
        return None
    return 1e3 * r.host_s.get("md.stale_read", 0.0) / r.span_steps
