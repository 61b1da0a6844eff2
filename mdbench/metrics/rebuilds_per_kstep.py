"""rebuilds_per_kstep: skin-list rebuilds in the window (the Simulator's
rebuild_count, summed over the window's run calls) per 1000 steps."""


def read(ctx):
    return 1e3 * ctx.rebuilds / ctx.steps if ctx.steps else None
