"""The whole predictor step's share of the card's float32-accurate
peak: the direct-convolution operations of the UNet forwards of the
window's calls (frozen counts; each call's patches padded to the
predictor's batch) over the window's seconds before the trace, at 165 TFLOP/s (3xTF32:
495 / 3, the fastest float32-accurate product rate of the card)."""

from benchmark import counts


def read(ctx):
    calls = len(ctx.steady.calls)
    if not calls:
        return None
    rate = calls * ctx.facts["flops_per_call"] / ctx.steady.seconds
    return 100 * rate / counts.F32_ACCURATE_FLOPS_PER_S
