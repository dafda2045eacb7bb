"""The ranks' exchanges: device time of the NCCL kernels (``nccl*``: the
gradients' all-reduce, BatchNorm's and the losses' sums over the ranks) of
the traced steps on rank 0, in ms per step.  A kernel's time includes its
wait for the slowest rank.  Nothing to read in a trace without them."""


def read(ctx):
    s = sum(d for _, d, name in ctx.trace.kernels if name.startswith("nccl"))
    return s / 1e3 / ctx.units if s else None
