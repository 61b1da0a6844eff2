"""roofline.ni_force (%): the kernel's least time for the work of its launches
(the configuration's `work`: operations over the f32 peak or bytes over
the memory rate, whichever is larger) over its device time in the profiled
stretch. PATTERN matches its name in torch.profiler's device events."""
PATTERN = r"\bni_force_kernel<"


def read(ctx):
    return ctx.roofline("ni_force", PATTERN)
