"""The beam loop: device kernel time inside the port's ``decode_loop`` range, in ms
per batch of the traced window."""


def read(ctx):
    s = ctx.trace.kernel_s_in("decode_loop")
    return None if s is None else s / ctx.units * 1e3
