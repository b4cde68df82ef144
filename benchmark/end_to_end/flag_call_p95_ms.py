"""The 95th percentile (nearest rank) of every call's latency in the
window, in ms: from entering ``flag_waterfalls`` until its flags are
ready on the card."""

from benchmark.window import percentile


def read(ctx):
    return percentile(ctx.window.latencies(), 95) * 1e3
