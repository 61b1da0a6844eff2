"""evaluate_ms_per_step (ms): time inside the force callables the
Simulator was handed (the evaluator: gather, descriptor kernel, network,
force kernel, delivery), under the harness's synchronised spans, over the
span stretch's steps."""


def read(ctx):
    if ctx.spans is None or not ctx.spans.steps:
        return None
    return 1e3 * ctx.spans.seconds["evaluate"] / ctx.spans.steps
