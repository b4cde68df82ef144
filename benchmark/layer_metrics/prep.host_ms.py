"""Host ms of a ``create_dataset`` call (no synchronisation inside it):
the median over the window's calls before the trace."""

from benchmark.window import median


def read(ctx):
    times = [c.extra["prep_host_s"] for c in ctx.steady.calls]
    return median(times) * 1e3 if times else None
