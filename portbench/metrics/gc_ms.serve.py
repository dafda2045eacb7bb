"""Python's garbage collector: host time inside the port's ``python.gc``
ranges (one a collection, on a thread the profiler records) within the
traced window, in ms per batch.  Nothing to read from a program without
the range."""
import sys


def read(ctx):
    name = getattr(sys.modules.get("acvae_tpu_torch.train.profiling"), "GC_RANGE", None)
    if name is None:
        return None
    t = ctx.trace
    us = sum(min(b, t.w1) - max(a, t.w0) for a, b, n, _ in t.host_ranges
             if n == name and a < t.w1 and b > t.w0)
    return us / 1e3 / ctx.units
