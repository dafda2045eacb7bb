"""The whole unit's share of the card's peak: the least time that the
published dense peaks allow for its model work at the precisions the
configuration states (``counts/work.py``), over its time in the run's
untraced window (the profiler slows a host-bound unit), in %."""


def read(ctx):
    return 100.0 * ctx.cell.per_unit_least_s() / ctx.unit_s
