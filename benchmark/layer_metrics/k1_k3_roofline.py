"""K1 and K3's identity mode (the 'auto' route of static prep), as a
share of their byte bound: each traced launch's bytes (frozen counts;
K1's from the distinct base patches that the traced calls' selections
read) at the HBM rate, over the launches' device time."""

from statistics import mean

from benchmark import counts

K1_KEYS = ("cluster_extract", "group_extract", "strip_extract", "init_keys")


def read(ctx):
    if ctx.trace is None:
        return None
    f = ctx.facts
    spans = ctx.trace.spans_named("create_dataset")
    kernels = ctx.trace.kernels_in("create_dataset")
    k1 = [k for k in kernels if counts.port_kernel(k.name, *K1_KEYS)]
    k3 = [k for k in kernels if counts.port_kernel(k.name, "plane_gather")]
    if not spans or not k1 or not k3:
        return None
    distinct = mean(f["n_distinct"][s.tag] for s in spans)
    bound = (len(k1) * counts.bound_ms(counts.k1_bytes(distinct, f["k"], f["px"]))
             + len(k3) * counts.bound_ms(counts.k3_identity_bytes(f["k"], f["px"])))
    return 100 * bound / (sum(k.us for k in k1 + k3) / 1e3)
