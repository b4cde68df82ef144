"""The whole MAD-flagging call's share of the card's peak. A MAD call
runs no model and is bound by memory, so its peak is the HBM rate: the
bytes K5 must move for the window's calls before the trace (frozen counts) over the
window's seconds, as a share of 3.35 TB/s. It bounds K5's roofline from
below whatever kernels the call runs."""

from benchmark import counts


def read(ctx):
    calls = len(ctx.steady.calls)
    if not calls:
        return None
    f = ctx.facts
    rate = calls * counts.k5_bytes(f["patches_per_call"], f["px"]) / ctx.steady.seconds
    return 100 * rate / counts.HBM_BYTES_PER_S
