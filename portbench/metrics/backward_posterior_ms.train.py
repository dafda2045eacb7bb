"""The train step's backward of the posterior: device kernel time launched inside
the port's ``backward.posterior`` range, which ``mark_backward`` opens on
autograd's thread once the region's gradients are complete, in ms per step
of the traced window."""


def read(ctx):
    s = ctx.trace.kernel_s_in("backward.posterior")
    return None if s is None else s / ctx.units * 1e3
