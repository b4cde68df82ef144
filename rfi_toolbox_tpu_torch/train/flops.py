"""Analytic operation count of a UNet train step.

A copy of ``bench.py:unet_train_flops_analytic``: the convolutions'
multiply-adds x 2 (multiply and add) x 3 (forward, input gradient and
weight gradient), for the ``space_to_depth=False`` UNet. Norms,
activations, pooling and the optimiser are left out (under 2% of the
convolutions' count at these shapes).
"""

__all__ = ["unet_train_flops_analytic"]


def unet_train_flops_analytic(batch, hw=128, in_ch=3, f=32, depth=4, out_ch=1):
    """Operations of one train step (forward + backward) at ``batch``
    images of ``hw`` x ``hw``."""
    macs = 0
    h = hw
    c_in = in_ch
    for i in range(depth):  # encoder DoubleConvs
        c = f * 2**i
        macs += h * h * 9 * (c_in * c + c * c)
        c_in = c
        h //= 2
    c = f * 2**depth  # bottleneck
    macs += h * h * 9 * (c_in * c + c * c)
    c_in = c
    for i in reversed(range(depth)):  # decoder stages
        co = f * 2**i
        h *= 2
        macs += h * h * c_in * co  # 2x2 stride-2 up-conv
        macs += h * h * 9 * (2 * co * co + co * co)  # concat DoubleConv
        c_in = co
    macs += hw * hw * f * out_ch  # final 1x1
    return 6 * macs * batch
