"""The optimizer chain: device kernel time inside the port's ``optimizer`` range, in ms
per step of the traced window."""


def read(ctx):
    s = ctx.trace.kernel_s_in("optimizer")
    return None if s is None else s / ctx.units * 1e3
