"""The frozen yardstick of the coherent flagging cell: the bytes the
coherent images must move, the operations of the 8-channel UNet's
forward, and the kernels of a traced call that make the images.

Every function takes the shapes the cell actually runs; the peaks and
the UNet's multiply-adds are ``counts.py``'s.
"""

from benchmark import counts

VIS_BYTES = 8  # complex64
IMAGE_BYTES = 4  # float32


def images_bytes(vis, images, px, channels=8):
    """The least bytes of a call's images: the block's ``vis`` complex64
    visibilities read once, and ``images`` float32 images of ``px``
    pixels x ``channels`` written once."""
    return vis * VIS_BYTES + images * px * channels * IMAGE_BYTES


def forward_flops(batch, hw, in_ch, f, depth):
    """Operations of one forward of ``batch`` images of ``hw``² with
    ``in_ch`` channels (2 a multiply-add; ``counts.unet_forward_macs``:
    the 3x3 convs, up-convs and head, taps on the zero padding included;
    norms and activations left out)."""
    return 2 * counts.unet_forward_macs(hw, in_ch, f, depth) * batch


def images_kernels(trace):
    """(calls, kernels) that made the images in a traced stretch: the
    kernels launched inside the program's ``coherent.images`` spans, and
    their count.

    A program from before the coherent spans (no ``coherent.call`` in the
    stretch) launches inside the benchmark's ``flag_waterfalls_coherent``
    span the images' kernels and the predictor's alone (unpatchify is a
    view of the flags), so there the kernels of that span outside its
    ``predictor`` span stand for them: the harness refuses a traced run
    in which a reader finds nothing, and such a program's traced run of
    the cell has to complete. A program that opens ``coherent.call`` but
    no ``coherent.images`` gives nothing, so that a renamed span refuses
    the run instead of changing what is read."""
    spans = trace.spans_named("coherent.images")
    if spans:
        return len(spans), trace.kernels_in("coherent.images")
    if trace.spans_named("coherent.call"):
        return 0, []
    predictor = {k.corr for k in trace.kernels_in("predictor")}
    return (len(trace.spans_named("flag_waterfalls_coherent")),
            [k for k in trace.kernels_in("flag_waterfalls_coherent") if k.corr not in predictor])
