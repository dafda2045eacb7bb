"""The encoder: device kernel time inside the port's ``encoder`` range, in ms
per batch of the traced window."""


def read(ctx):
    s = ctx.trace.kernel_s_in("encoder")
    return None if s is None else s / ctx.units * 1e3
