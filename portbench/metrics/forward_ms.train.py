"""The train step's forward: device kernel time inside the port's ``forward`` range, in ms
per step of the traced window."""


def read(ctx):
    s = ctx.trace.kernel_s_in("forward")
    return None if s is None else s / ctx.units * 1e3
