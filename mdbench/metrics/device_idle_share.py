"""device_idle_share (%): 1 - the union of the device's operations over the
profiled stretch's wall time (whole blocks, rebuilds included)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0.0 \
            or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
