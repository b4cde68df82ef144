"""Device ms a call of the coherent images: the kernels launched inside
the program's ``coherent.images`` spans (patchify, ``to_8ch`` and the
robust scale of ``coherent_images``) over the traced calls
(``coherent_counts.images_kernels``)."""

from benchmark import coherent_counts


def read(ctx):
    if ctx.trace is None:
        return None
    calls, kernels = coherent_counts.images_kernels(ctx.trace)
    if not calls or not kernels:
        return None
    return sum(k.us for k in kernels) / 1e3 / calls
