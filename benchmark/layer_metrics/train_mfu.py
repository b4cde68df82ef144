"""The whole train step's share of the card's dense bfloat16 peak: the
analytic operations of the steps of the window before the trace (a frozen copy of
``train/flops.py``) over the window's seconds before the trace."""

from benchmark import counts


def read(ctx):
    steps = sum(c.work["steps"] for c in ctx.steady.calls)
    if not steps:
        return None
    rate = steps * ctx.facts["flops_per_step"] / ctx.steady.seconds
    return 100 * rate / counts.BF16_FLOPS_PER_S
