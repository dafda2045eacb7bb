"""The beam's top-k: device kernel time inside the port's ``beam_topk`` range, in ms
per batch of the traced window."""


def read(ctx):
    s = ctx.trace.kernel_s_in("beam_topk")
    return None if s is None else s / ctx.units * 1e3
