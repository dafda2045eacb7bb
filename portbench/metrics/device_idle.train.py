"""The device's idle share: the part of the traced window in which no
kernel, copy or set ran, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
