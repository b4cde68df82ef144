"""Share of the traced stretch in which no operation ran on the device:
1 - busy / stretch, both from the trace (``trace.py``): busy is the
union of the device operations' intervals, the stretch runs from the
first marker's start to the second's end on the device's clock. The
profiler records the device alone, yet each launch is a little slower
under it, so this may read above the untraced window's idle share."""


def read(ctx):
    if ctx.trace is None:
        return None
    idle = 1 - ctx.trace.busy_us / ctx.trace.window_us
    if idle < 0:
        raise ValueError(f"the device was busy {ctx.trace.busy_us} us of a "
                         f"{ctx.trace.window_us} us stretch")
    return 100 * idle
