"""Device ms a train step: the kernels launched inside the benchmark's
spans around ``train_steps`` (autograd's thread included), over the
steps of those spans."""


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.spans_named("train_steps")
    kernels = ctx.trace.kernels_in("train_steps")
    if not spans or not kernels:
        return None
    return sum(k.us for k in kernels) / 1e3 / (len(spans) * ctx.facts["steps_per_call"])
