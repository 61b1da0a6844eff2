"""step_mfu (%): the step's model FLOPs (descriptors, network forward and
input gradient, forces; the configuration's `work`, counted on the census
of the window's end positions) times the window's steps, over the window's
wall time and the f32 peak (counts.PEAK_F32_FLOPS)."""
from mdbench import counts


def read(ctx):
    if ctx.wall <= 0.0:
        return None
    return 100.0 * ctx.work["step"] * ctx.steps / ctx.wall \
        / counts.PEAK_F32_FLOPS
