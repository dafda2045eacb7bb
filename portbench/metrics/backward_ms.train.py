"""The train step's backward: device kernel time of the traced steps
outside the ``augment``, ``forward`` and ``optimizer`` ranges (autograd
runs the backward on its own thread, outside the ``backward`` range), in
ms per step.  The method of ``chip_smoke.py::profile_steps`` (:992-1047)."""


def read(ctx):
    t = ctx.trace
    parts = [t.kernel_s_in(k) or 0.0 for k in ("augment", "forward", "optimizer")]
    return (t.kernel_s() - sum(parts)) / ctx.units * 1e3
