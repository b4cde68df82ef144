"""K5 (MAD flags, one launch a MAD-flagging call) as a share of its byte
bound: each traced launch's bytes (frozen counts, the call's patches) at
the HBM rate, over the launches' device time."""

from benchmark import counts


def read(ctx):
    if ctx.trace is None:
        return None
    k5 = [k for k in ctx.trace.kernels_in("flag_waterfalls") if counts.port_kernel(k.name, "mad_flag")]
    if not k5:
        return None
    f = ctx.facts
    bound = len(k5) * counts.bound_ms(counts.k5_bytes(f["patches_per_call"], f["px"]))
    return 100 * bound / (sum(k.us for k in k5) / 1e3)
