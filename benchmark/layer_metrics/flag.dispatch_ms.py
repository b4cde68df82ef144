"""Host ms from entering ``flag_waterfalls`` until it returns, before
the wait for the card: the median over the window's calls before the trace."""

from benchmark.window import median


def read(ctx):
    times = [c.returned - c.start for c in ctx.steady.calls]
    return median(times) * 1e3 if times else None
