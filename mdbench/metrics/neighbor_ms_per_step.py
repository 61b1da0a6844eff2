"""neighbor_ms_per_step (ms): time inside Simulator.rebuild (the skin list
and its short-list refresh) and the short_build callable (compact_short),
under the harness's synchronised spans, over the span stretch's steps."""


def read(ctx):
    if ctx.spans is None or not ctx.spans.steps:
        return None
    return 1e3 * ctx.spans.seconds["neighbor"] / ctx.spans.steps
