"""The train step's backward, device idle: the idle time of the traced
window whose gaps began while one of the port's ``backward.*`` ranges was
the innermost open range, in ms per step.  Nothing to read from a program
without those ranges."""


def read(ctx):
    t = ctx.trace
    if not any(name.startswith("backward.") for _, _, name, _ in t.host_ranges):
        return None
    gaps = t.idle_gaps(top=len(t.host_ranges) + 1)     # every label
    return sum(s for label, s in gaps if label.startswith("backward.")) / ctx.units * 1e3
