"""K4 (3-channel extraction, one launch a model-flagging call) as a
share of its byte bound: each traced launch's bytes (frozen counts, the
call's patches) at the HBM rate, over the launches' device time."""

from benchmark import counts

KEYS = ("cluster_extract", "group_extract", "strip_extract", "init_keys")


def read(ctx):
    if ctx.trace is None:
        return None
    k4 = [k for k in ctx.trace.kernels_in("flag_waterfalls") if counts.port_kernel(k.name, *KEYS)]
    if not k4:
        return None
    f = ctx.facts
    bound = len(k4) * counts.bound_ms(counts.k4_bytes(f["patches_per_call"], f["px"]))
    return 100 * bound / (sum(k.us for k in k4) / 1e3)
