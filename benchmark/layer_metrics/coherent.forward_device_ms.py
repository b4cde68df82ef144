"""Device ms of one forward of the predictor's batch: the kernels
launched inside the program's ``predict.logits`` spans (the model's
forward on one batch, by the ``"eager"`` route for a GroupNorm UNet)
over their count."""


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.spans_named("predict.logits")
    kernels = ctx.trace.kernels_in("predict.logits")
    if not spans or not kernels:
        return None
    return sum(k.us for k in kernels) / 1e3 / len(spans)
