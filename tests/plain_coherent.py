"""A plain reference of the coherent flagging path, for the tests: the
8-channel images of ``flag_waterfalls_coherent`` and the GroupNorm UNet
that flags them, in plain ``torch`` and ``torch.nn.functional``, in
float32 with TF32 off.

It is the benchmark's reference, ``benchmark/reference/coherent.py``,
re-exported, so that one copy of the mathematics holds both the tests
and the benchmark's comparison; that module's docstring gives the
published model (U-Net with GroupNorm, 8 groups, eps 1e-6; the
reference toolbox's 4 pols x (re, im) images, robust-scaled a patch) and
each departure from it. Like that module, this one imports neither JAX
nor the JAX package nor any module or kernel of the port; the tests hand
it the port's parameters by name (``encoders.{i}.block.conv1.weight``,
``...norm1.weight``, ..., ``decoders.{i}.up.weight``, ``head.weight``).
Beside it this module keeps :func:`logits` with TF32 turned off, and
:func:`flags`.
"""

import torch

from benchmark.reference import coherent as _ref
from benchmark.reference.coherent import (coherent_images, forward, group_norm, patchify,
                                          quantiles, robust_scale, to_8ch, unpatchify)

__all__ = ["patchify", "unpatchify", "to_8ch", "quantiles", "robust_scale", "coherent_images",
           "group_norm", "forward", "logits", "flags"]


def logits(params, images, batch, depth=4):
    """(N, p, p, 8) images -> (N, p, p) logits, the forward run in blocks
    of ``batch`` images. TF32 is turned off, for float32 products on a
    card too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _ref.logits(params, images, batch, depth)


def flags(params, vis4, p, threshold, batch, depth=4):
    """(B, 4, C, T) complex64 -> (B, C, T) flags, one mask a baseline, and
    the logits they were cut from, unpatchified: ``sigmoid(logit) >
    threshold``."""
    b, _, c, t = vis4.shape
    z = logits(params, coherent_images(vis4, p), batch, depth)
    return unpatchify(torch.sigmoid(z) > threshold, b, c, t), unpatchify(z, b, c, t)
