"""Channel-sharded preprocessing of large waterfalls, and global
statistics over a sharded array.

Counterpart of ``rfi_toolbox_tpu/parallel/spatial.py``. The extraction's
stencil is the 1-pixel forward difference within a patch, so slabs of
the channel axis cut at patch boundaries need no halo: each rank pads,
takes its slab, patchifies and extracts it (kernel K4 on the card,
``ops.fused_extract_channels``; its plain version on the CPU), and an
``all_gather`` puts the patches back in the canonical (waterfall, row,
column) order. :func:`sharded_global_stats` sums over the ranks for the
mean and the standard deviation and finds the exact median by a
bit-level search with an all-reduced count per step.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fused_extract_channels
from ..preprocess import pipeline as PP
from .mesh import batch_sharding

__all__ = ["preprocess_sharded", "sharded_global_stats"]


def preprocess_sharded(waterfalls, mesh, patch_size=128, axis="data"):
    """Patchify + 3-channel extraction with the channel axis sharded.

    Args:
        waterfalls: (M, C, T) complex or real, numpy or a tensor; every
            rank passes the whole array.
        mesh: a :class:`~rfi_toolbox_tpu_torch.parallel.mesh.Mesh`.

    Returns:
        (N, patch, patch, 3) float32 images on the mesh's device, on every
        rank, in the unsharded ``fused_extract_channels(patchify_batch(...))``
        order (within K4's 2e-5 of the plain extraction). Channel counts
        that do not divide shards * patch_size are zero-padded up (the
        padding patchify applies) and the padding-only patch rows are
        dropped.
    """
    x = torch.as_tensor(waterfalls)
    x = x.to(mesh.device, torch.complex64 if x.is_complex() else torch.float32)
    m, c, t = x.shape
    n_shards = mesh.shape[axis]
    rows = max(1, -(-c // patch_size))
    rows_p = -(-rows // n_shards) * n_shards
    rows_per_shard = rows_p // n_shards
    slab = rows_per_shard * patch_size
    lo = mesh.local_rank(axis) * slab
    local = x[:, lo:lo + slab]
    if local.shape[1] < slab:  # the zero padding of the last slabs
        local = torch.cat([local, local.new_zeros((m, slab - local.shape[1], t))], 1)
    images = fused_extract_channels(PP.patchify_batch(local, patch_size).contiguous())
    parts = [torch.empty_like(images) for _ in range(n_shards)]
    dist.all_gather(parts, images, group=mesh.get_group(axis))
    cols = max(1, -(-t // patch_size))
    img = torch.stack(parts).reshape(n_shards, m, rows_per_shard, cols, patch_size,
                                     patch_size, 3)
    img = img.transpose(0, 1).reshape(m, rows_p, cols, patch_size, patch_size, 3)
    return img[:, :rows].reshape(m * rows * cols, patch_size, patch_size, 3)


def _f32_of_bits(bits):
    """The float32 whose IEEE pattern is the unsigned 32-bit ``bits``."""
    return np.array(bits, np.uint32).view(np.float32)


def sharded_global_stats(values, mesh, axis="data", median_iters=32):
    """Global mean, std and median of an array split on its first axis.

    Every rank passes the whole array and reduces its rows (the first
    axis must divide ``mesh``'s ``axis``). The mean and the standard
    deviation take one all-reduce each; the median is exact for
    non-negative float32 values, by the JAX package's bit-level search:
    ``median_iters`` steps, each setting one bit of the lower and the
    upper middle rank's IEEE pattern from an all-reduced count of the
    values below the candidate (the two searches share one all-reduce a
    step). The patterns are compared as int64, which holds every uint32.

    Returns ``{"mean", "std", "median"}`` as Python floats.
    """
    group = mesh.get_group(axis)
    x = torch.as_tensor(values).to(mesh.device, torch.float32)
    if x.shape[0] % mesh.shape[axis]:
        raise ValueError(f"{x.shape[0]} rows do not divide the mesh's {axis!r} axis "
                         f"({mesh.shape[axis]})")
    flat = batch_sharding(mesh, axis).local(x).reshape(-1)
    sums = torch.stack([torch.tensor(float(flat.numel()), device=flat.device), flat.sum()])
    dist.all_reduce(sums, group=group)
    n, total = sums[0], sums[1]
    mean = total / n
    var = ((flat - mean) ** 2).sum()
    dist.all_reduce(var, group=group)
    var = var / n

    bits = flat.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    count = int(n)
    ranks = torch.tensor([(count - 1) // 2, count // 2], device=flat.device)  # lo, hi
    prefix = torch.zeros(2, dtype=torch.int64, device=flat.device)
    for b in range(median_iters):
        cand = prefix | (1 << (31 - b))
        below = (bits[None, :] < cand[:, None]).sum(1)
        dist.all_reduce(below, group=group)
        prefix = torch.where(below <= ranks, cand, prefix)
    lo, hi = prefix.tolist()
    median = np.float32(0.5) * (_f32_of_bits(lo) + _f32_of_bits(hi))
    return {"mean": float(mean), "std": float(var.sqrt()), "median": float(median)}
