"""Static-shape preprocessing with virtual rotation augmentation.

Counterpart of ``rfi_toolbox_tpu/preprocess/static_prep.py``. It rests on
two exact identities:

1. When the waterfall is a whole number of patches, each patch of a
   flipped/transposed waterfall is a flipped/transposed base patch at a
   remapped grid index (:func:`variant_remap`).
2. Per-patch statistics (MAD flags, any-flag, median normalisation,
   stretch) do not change under flips and transposes.

So the base patches are cut once, flags are computed on them, the
4x-augmented any-flag vector is built by index remap, ``k`` patches are
selected on the device in the materialised path's virtual order, and
only the selected patches are transformed. The output equals the
materialised ``static_num_patches`` path's for the same selection.

:class:`StaticPrep` splits the work at the selection: :meth:`base`
(patchify, real-input steps, flags, any-flag vector), the selection
(:func:`.pipeline.static_select_from_has`, the only random step), and
:meth:`from_keep` (everything downstream of
``keep``, deterministic), so that a test can feed the reference's
``keep`` and compare everything after it.

Extraction routes (``extract``):

- ``'gathered'``: extract the K transformed patches (K4 with kernels);
- ``'base'``: with kernels, K1 (gather + extraction in one pass) then
  K3's variant transform of its three planes into the images; without,
  the plain planes of the M base patches, a gather, a stack and the
  transform;
- ``'planes'``: with kernels, K2 on the M base patches, then K3 (plane
  gather + transform, written as the images); without, as ``'base'``;
- ``'auto'``: ``'base'`` when rotations > 1 and K exceeds the base-patch
  count, else ``'gathered'``.

Real input gets the min-max log-amplitude and a zero phase on every
route, from the kernels as from their plain versions.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import ops
from ..utils.profiling import span
from . import pipeline as P

__all__ = [
    "variant_remap",
    "transform_by_variant",
    "transform_by_variant_nhwc",
    "VARIANT_GRAD_PLANE",
    "Base",
    "StaticPrep",
    "make_static_prep_fn",
]

_N_VARIANTS = {1: 1, 2: 2, 4: 4}

# gradient plane per variant [orig, flipud, T, flipud.T]; see
# pipeline.extract_channel_planes (orig and T share plane 0)
VARIANT_GRAD_PLANE = np.array([0, 1, 0, 2], dtype=np.int32)


@functools.cache
def variant_remap(nh, nw, rotations):
    """(R, nh*nw) int32 base-patch index of each virtual variant patch:
    row r maps the row-major patch index within variant r's orientation
    to the base patch index. Transposed variants use the transposed grid
    (nw, nh); each variant has the same patch count."""
    if rotations not in _N_VARIANTS:
        raise ValueError(f"rotations must be 1, 2, or 4, got {rotations}")
    i, j = np.divmod(np.arange(nh * nw), nw)
    rows = [i * nw + j]
    if rotations >= 2:
        rows.append((nh - 1 - i) * nw + j)
    if rotations == 4:
        ti, tj = np.divmod(np.arange(nw * nh), nh)
        rows.append(tj * nw + ti)
        rows.append(tj * nw + (nw - 1 - ti))
    return np.stack(rows).astype(np.int32)


def transform_by_variant(x, v):
    """Variant v's transpose, then its row flip, of square (K, p, p)
    patches: v = 0 orig, 1 flipud, 2 T, 3 flipud.T."""
    is_t = (v >= 2)[:, None, None]
    is_f = ((v == 1) | (v == 3))[:, None, None]
    x = torch.where(is_t, x.transpose(-1, -2), x)
    return torch.where(is_f, x.flip(-2), x)


def transform_by_variant_nhwc(x, v):
    """:func:`transform_by_variant` over the H/W axes of (K, p, p, C)."""
    is_t = (v >= 2)[:, None, None, None]
    is_f = ((v == 1) | (v == 3))[:, None, None, None]
    x = torch.where(is_t, x.transpose(1, 2), x)
    return torch.where(is_f, x.flip(1), x)


@functools.cache
def _device_constant(name, device, *args):
    """The remap table (``"remap"``, args nh, nw, rotations) or
    :data:`VARIANT_GRAD_PLANE` (``"grad_plane"``) as an int64 tensor on
    ``device``, copied there once: a copy from host memory in the loop
    would wait for the card's queue."""
    table = variant_remap(*args) if name == "remap" else VARIANT_GRAD_PLANE
    return torch.from_numpy(table).to(device).long()


class Base(NamedTuple):
    """What :meth:`StaticPrep.base` computes before the selection."""

    base: torch.Tensor  # (M*kpp, p, p) base patches
    base_f: torch.Tensor  # (M*kpp, p, p) bool flags
    has: torch.Tensor  # (M*R*kpp,) bool virtual any-flag vector
    nh: int  # patch rows of a waterfall
    nw: int  # patch columns of a waterfall


class StaticPrep:
    """The static preprocess for one configuration (the JAX package's
    ``make_static_prep_fn``, with ``use_kernels`` for ``use_pallas``).

    Args:
        patch_size: square patch side; the waterfall sides must be
            multiples of it.
        k: number of patches returned.
        rotations: 1, 2 or 4 virtual augmentation variants.
        flags_mode: ``'custom'`` (per-pixel flags passed in) or ``'mad'``
            (MAD flags at ``flag_sigma`` on the base patches; K5 with
            kernels).
        use_kernels: launch the CUDA kernels for tensors on the card.
        stretch / normalize_*: the real-input steps, on the base patches;
            skipped for complex input.
        extract: ``'auto'``, ``'base'``, ``'gathered'`` or ``'planes'``
            (see the module docstring).
        return_patches: also gather the transformed raw patches.

    Calling it, ``prep(flat, flag_flat, generator)``, returns ``(images
    (K, p, p, 3) float32, labels (K, p, p) uint8, patches (K, p, p) or
    None, flag_patches (K, p, p) bool)`` for (M, H, W) waterfalls
    ``flat`` whose sides are multiples of the patch size. ``flag_flat``
    holds per-pixel flags (``flags_mode='custom'``; nonzero is flagged)
    and is ignored for ``flags_mode='mad'``. ``generator`` is a
    ``torch.Generator`` on the waterfalls' device. The selected virtual
    indices are kept in :attr:`keep`.
    """

    def __init__(self, patch_size, k, rotations=4, flags_mode="custom",
                 flag_sigma=5.0, use_kernels=True, stretch=None,
                 normalize_before_stretch=True, normalize_after_stretch=False,
                 extract="auto", return_patches=True):
        if extract not in ("auto", "base", "gathered", "planes"):
            raise ValueError(f"unknown extract mode {extract!r}")
        if flags_mode not in ("custom", "mad"):
            raise ValueError(f"unknown flags_mode {flags_mode!r}")
        if rotations not in _N_VARIANTS:
            raise ValueError(f"rotations must be 1, 2, or 4, got {rotations}")
        self.patch_size = int(patch_size)
        self.k = int(k)
        self.rotations = rotations
        self.flags_mode = flags_mode
        self.flag_sigma = float(flag_sigma)
        self.use_kernels = bool(use_kernels)
        self.stretch = stretch
        self.normalize_before_stretch = normalize_before_stretch
        self.normalize_after_stretch = normalize_after_stretch
        self.extract = extract
        self.return_patches = return_patches
        self.keep = None

    def base(self, flat, flag_flat):
        """(M, H, W) waterfalls -> :class:`Base`: the base patches after
        the real-input steps, their flags, and the virtual any-flag
        vector in the materialised path's order ``(wf*R + v)*kpp + p_v``;
        in the ``prep.base`` span."""
        with span("prep.base"):
            p = self.patch_size
            m, h, w = flat.shape
            if h % p or w % p or (h <= p and w <= p):
                raise ValueError(
                    f"the static path needs whole patches of {p}, got {h} x {w}")
            nh, nw = h // p, w // p
            base = P.patchify_batch(flat, p)
            if not base.is_complex():
                if self.normalize_before_stretch:
                    base = P.normalize_by_median(base)
                if self.stretch:
                    base = P.apply_stretch(base, self.stretch)
                if self.normalize_after_stretch:
                    base = P.normalize_by_median(base)
            if self.flags_mode == "custom":
                base_f = P.patchify_batch(flag_flat != 0, p)
            elif self.use_kernels:
                base_f = ops.mad_flag_patches(base.contiguous(), self.flag_sigma)
            else:
                base_f = P.mad_flag_patches(base, self.flag_sigma)
            remap = _device_constant("remap", base.device, nh, nw, self.rotations)
            base_any = base_f.reshape(m, nh * nw, -1).any(dim=-1)
            has = base_any[:, remap].reshape(-1)
            return Base(base, base_f, has, nh, nw)

    def indices(self, b, keep):
        """Virtual indices ``keep`` (K,) -> ``(base_idx, variant, pidx)``
        (K,) int64: the base patch, the variant [orig, flipud, T,
        flipud.T] and the gradient plane of each selected patch."""
        r = _N_VARIANTS[self.rotations]
        kpp = b.nh * b.nw
        remap = _device_constant("remap", keep.device, b.nh, b.nw,
                                 self.rotations).reshape(-1)
        keep = keep.long()
        v = (keep // kpp) % r
        base_idx = (keep // (r * kpp)) * kpp + remap[v * kpp + keep % kpp]
        return base_idx, v, _device_constant("grad_plane", keep.device)[v]

    def patches(self, b, keep):
        """The selected raw patches (K, p, p), transformed to their
        variants: :class:`Base` ``b`` gathered at the virtual indices
        ``keep``."""
        base_idx, v, _ = self.indices(b, keep)
        return transform_by_variant(b.base[base_idx], v)

    def from_keep(self, b, keep):
        """Everything downstream of the selection: for :class:`Base` ``b``
        and the virtual indices ``keep`` (K,), ``(images, labels,
        patches, flag_patches)`` as :class:`StaticPrep` returns them; in
        the ``prep.extract`` span."""
        with span("prep.extract"):
            base, base_f = b.base, b.base_f
            r = _N_VARIANTS[self.rotations]
            n_base = base.shape[0]
            base_idx, v, pidx = self.indices(b, keep)

            flag_patches = transform_by_variant(base_f[base_idx], v)
            labels = flag_patches.to(torch.uint8)
            patches = self.patches(b, keep) if self.return_patches else None
            extract_base = self.extract in ("base", "planes") or (
                self.extract == "auto" and r > 1 and self.k > n_base)
            kernels = self.use_kernels
            if extract_base:
                if kernels and self.extract == "planes":
                    planes = ops.fused_extract_channel_planes(base.contiguous())
                    images = ops.fused_plane_gather_transform_images(
                        planes, base_idx, pidx, v)
                elif kernels:
                    planes = ops.fused_gather_extract(base.contiguous(), base_idx, pidx)
                    images = ops.fused_plane_gather_transform_images(planes, None, None, v)
                else:
                    planes = ops.fused_gather_extract_plain(base, base_idx, pidx)
                    images = transform_by_variant_nhwc(torch.stack(planes, dim=-1), v)
            else:
                src = patches if patches is not None else transform_by_variant(
                    base[base_idx], v)
                if kernels:
                    images = ops.fused_extract_channels(src.contiguous())
                else:
                    images = ops.fused_extract_channels_plain(src)
            return images, labels, patches, flag_patches

    def __call__(self, flat, flag_flat, generator):
        b = self.base(flat, flag_flat)
        self.keep = P.static_select_from_has(b.has, self.k, generator)
        return self.from_keep(b, self.keep)


make_static_prep_fn = StaticPrep
