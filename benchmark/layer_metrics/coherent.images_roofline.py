"""The coherent images as a share of their byte bound: each traced call's
least bytes (frozen counts: the block's complex64 visibilities read once,
its float32 8-channel images written once) at the HBM rate, over the
device time of the kernels that made them
(``coherent_counts.images_kernels``)."""

from benchmark import coherent_counts, counts


def read(ctx):
    if ctx.trace is None:
        return None
    calls, kernels = coherent_counts.images_kernels(ctx.trace)
    if not calls or not kernels:
        return None
    bound = calls * counts.bound_ms(ctx.facts["images_bytes"])
    return 100 * bound / (sum(k.us for k in kernels) / 1e3)
