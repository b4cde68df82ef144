"""Device ms of the predictor a call: the kernels launched inside the
benchmark's span around its hand-off to ``CompiledPredictor``, less the
port's kernels and the copies, over the traced calls."""

from benchmark import counts


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.spans_named("predictor")
    kernels = [k for k in ctx.trace.kernels_in("predictor")
               if counts.classify(k.name) not in ("port kernels", "copies")]
    if not spans or not kernels:
        return None
    return sum(k.us for k in kernels) / 1e3 / len(spans)
