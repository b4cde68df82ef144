"""The static training-patch preparation, in plain PyTorch.

The published recipe (``Preprocessor.create_dataset(patch_size,
use_custom_flags=True, seed, static_num_patches=K)`` with 4 rotation
variants): every waterfall and its flags are cut into patches; the 4
variants of each waterfall [as is, rows flipped, transposed, transposed
then rows flipped] give virtual patches, indexed (waterfall, variant,
patch within the variant's own grid); the flagged virtual patches are
taken in that order, repeated cyclically up to K (all of them cycle
where none is flagged), and shuffled by ``torch.randperm(K)`` drawn from
a generator seeded with ``seed`` on the waterfalls' device. Each kept
patch is the variant of its base patch; its label is the variant of the
base patch's flags, and its image the extraction of the transformed
patch.
"""

import torch

from .extract import images, patchify, transform

ROTATIONS = 4


def variant_remap(nh, nw):
    """(4, nh * nw) base-patch index of each variant's patches, in the
    variant's own row-major grid (the transposed variants' grid is nw x
    nh)."""
    i, j = torch.div(torch.arange(nh * nw), nw, rounding_mode="floor"), torch.arange(nh * nw) % nw
    ti, tj = torch.div(torch.arange(nh * nw), nh, rounding_mode="floor"), torch.arange(nh * nw) % nh
    return torch.stack([i * nw + j, (nh - 1 - i) * nw + j, tj * nw + ti, tj * nw + (nw - 1 - ti)])


def select(has, k, seed):
    """Kept virtual indices (K,) of an any-flag vector ``has``."""
    flagged = torch.nonzero(has).flatten()
    pool = flagged if flagged.numel() else torch.arange(has.numel(), device=has.device)
    kept = pool[torch.arange(k, device=has.device) % pool.numel()]
    g = torch.Generator(device=has.device).manual_seed(seed)
    return kept[torch.randperm(k, generator=g, device=has.device)]


def base_of(keep, nh, nw):
    """Virtual indices -> (base patch index, variant)."""
    kpp = nh * nw
    remap = variant_remap(nh, nw).to(keep.device)
    v = (keep // kpp) % ROTATIONS
    return (keep // (ROTATIONS * kpp)) * kpp + remap[v, keep % kpp], v


def static_prep(waterfalls, flags, patch, k, seed, q=None):
    """(B, H, W) complex64 waterfalls and their bool flags -> (images (K,
    p, p, 3) float32, labels (K, p, p) uint8, keep (K,))."""
    b, h, w = waterfalls.shape
    nh, nw = h // patch, w // patch
    base = patchify(waterfalls, patch)
    base_f = patchify(flags, patch)
    any_f = base_f.reshape(b, nh * nw, -1).any(dim=-1)
    remap = variant_remap(nh, nw).to(any_f.device)
    has = any_f[:, remap].reshape(-1)
    keep = select(has, k, seed)
    idx, v = base_of(keep, nh, nw)
    labels = transform(base_f[idx], v).to(torch.uint8)
    return images(transform(base[idx], v), q), labels, keep
