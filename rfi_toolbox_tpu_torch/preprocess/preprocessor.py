"""Preprocessor: waterfalls -> training patches, on the card.

Counterpart of ``rfi_toolbox_tpu/preprocess/preprocessor.py``:
``Preprocessor``, and ``DevicePreprocessor`` (alias ``GPUPreprocessor``),
which returns raw complex patches and their masks for
:class:`~rfi_toolbox_tpu_torch.train.raw_patches.RawPatchTrainer`.
Pipeline order of ``create_dataset``:

  1. rotation augmentation (or flatten baselines x pols)
  2. patchify (skipped when the waterfall fits in one patch)
  3-5. normalise/stretch/normalise, real input only
  6. flags: inference -> zeros; custom -> rotated and patchified; else MAD
  7. blank-patch removal (skipped in inference mode)
  8. shuffle (skipped in inference mode), truncation, 3-channel
     extraction with the ImageNet affine.

With ``static_num_patches`` and whole patches, the fused static path
(:mod:`.static_prep`) does all of it on the device without a host sync.
"""

import logging

import numpy as np
import torch

from .. import ops
from ..data.batched_dataset import ArrayDataset
from ..utils.device import resolve_device
from . import pipeline as P
from .static_prep import make_static_prep_fn

logger = logging.getLogger(__name__)

__all__ = ["Preprocessor", "DevicePreprocessor", "GPUPreprocessor"]


def _flatten_waterfalls(data, device, dtype=None):
    """(B, P, H, W) or (P, H, W) array or tensor -> (B*P, H, W) tensor on
    ``device`` (cast to ``dtype`` if given)."""
    x = torch.as_tensor(data).to(device=device, dtype=dtype)
    if x.ndim == 3:
        x = x[None]
    if x.ndim != 4:
        raise ValueError(f"Data must be 3D or 4D, got shape {tuple(x.shape)}")
    b, p, h, w = x.shape
    return x.reshape(b * p, h, w)


def _augment_and_patchify(flat, patch_size, num_rotations, do_patch):
    """Rotation augmentation and patchify of (M, H, W) waterfalls, in the
    reference's per-waterfall order [orig, flip, T, flipT]. Returns
    ``(patches, patches per waterfall variant)``; non-square waterfalls
    patchify the transposed group apart and interleave."""
    group_a, group_b = P.apply_rotations(flat, num_rotations)
    m, r_a = group_a.shape[0], group_a.shape[1]
    if not do_patch:
        if group_b is not None and group_a.shape[-2:] != group_b.shape[-2:]:
            raise ValueError(
                "4-way rotation without patchification requires square "
                f"waterfalls; got {tuple(group_a.shape[-2:])}"
            )
        groups = [group_a] if group_b is None else [group_a, group_b]
        patches = torch.cat(groups, dim=1)
        return patches.reshape(m * patches.shape[1], *patches.shape[2:]), 1

    pa = P.patchify_batch(group_a.reshape(m * r_a, *group_a.shape[2:]), patch_size)
    k = pa.shape[0] // (m * r_a)
    pa = pa.reshape(m, r_a, k, patch_size, patch_size)
    if group_b is None:
        patches = pa
    else:
        pb = P.patchify_batch(group_b.reshape(m * 2, *group_b.shape[2:]), patch_size)
        patches = torch.cat([pa, pb.reshape(m, 2, k, patch_size, patch_size)], dim=1)
    return patches.reshape(-1, patch_size, patch_size), k


class Preprocessor:
    """Preprocess waterfalls into training patches on the card.

    >>> pre = Preprocessor(data, flags=exact_masks)
    >>> ds = pre.create_dataset(patch_size=128, use_custom_flags=True)
    >>> ds.images.shape, ds.labels.shape   # (N, 128, 128, 3), (N, 128, 128)

    Args:
        data: waterfalls (baselines, pols, channels, times) or (pols,
            channels, times), complex or real, array or tensor.
        flags: optional flags of the same shape.
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.
    """

    def __init__(self, data, flags=None, device=None):
        if not hasattr(data, "ndim"):
            data = np.asarray(data)
        if data.ndim == 3:
            data = data[None]
        elif data.ndim != 4:
            raise ValueError(f"Data must be 3D or 4D, got shape {tuple(data.shape)}")
        self.data = data
        self.flags = flags
        self.device = device
        self._patches = None
        self._patches_thunk = None
        self.patch_flags = None
        self.keep = None
        self.dataset = None
        self.original_shapes = None

    @property
    def patches(self):
        """Selected raw patches (N, p, p) on the device. The static path
        does not gather them for training; the first access does."""
        if self._patches is None and self._patches_thunk is not None:
            self._patches = self._patches_thunk()
            self._patches_thunk = None
        return self._patches

    @patches.setter
    def patches(self, value):
        self._patches = value
        self._patches_thunk = None

    def create_dataset(self, patch_size=128, stretch=None, flag_sigma=5,
                       use_custom_flags=True, num_patches=None,
                       normalize_before_stretch=True,
                       normalize_after_stretch=False, num_workers=4,
                       enable_augmentation=True, augmentation_rotations=4,
                       inference_mode=False, seed=None, use_kernels=True,
                       pad_to_multiple=None, static_num_patches=None,
                       extract="auto"):
        """Create an :class:`ArrayDataset` of 3-channel patches (float32
        NHWC) and label masks (uint8).

        Arguments as the JAX package's; ``num_workers`` is ignored.
        ``seed`` drives the shuffle: numpy's ``default_rng(seed)`` on the
        materialised path (as the reference), a ``torch.Generator`` on
        the device seeded with it (0 when None) on the static path.
        ``use_kernels``: launch the CUDA kernels (K1-K5) for data on the
        card; False runs their plain versions. ``static_num_patches``:
        return exactly this many patches, selected on the device
        (flagged first, cyclic repeats on deficit, truncation on
        surplus); mutually exclusive with ``num_patches`` and
        ``pad_to_multiple``, ignored in inference mode. ``extract``: the
        static path's extraction route (``'auto'``, ``'base'``,
        ``'gathered'``, ``'planes'``; see :mod:`.static_prep`). The
        selected indices are kept in :attr:`keep`.
        """
        del num_workers
        dev = resolve_device(self.device)
        is_complex = torch.as_tensor(self.data[:1]).is_complex()
        dtype = torch.complex64 if is_complex else torch.float32
        flat = _flatten_waterfalls(self.data, dev, dtype)
        rotations = augmentation_rotations if enable_augmentation else 1
        rotations = max(rotations, 1)

        h, w = flat.shape[-2:]
        do_patch = not (h <= patch_size and w <= patch_size)
        self.original_shapes = [(h, w)] * (flat.shape[0] * (rotations if do_patch else 1))
        metadata = {
            "patch_size": patch_size,
            "stretch": stretch,
            "flag_sigma": flag_sigma,
            "normalize_before_stretch": normalize_before_stretch,
            "normalize_after_stretch": normalize_after_stretch,
            "augmentation_rotations": rotations,
            "original_shapes": self.original_shapes,
        }
        have_custom = use_custom_flags and self.flags is not None
        if static_num_patches and not inference_mode and (num_patches or pad_to_multiple):
            raise ValueError("static_num_patches is mutually exclusive with "
                             "num_patches / pad_to_multiple")
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed if seed is not None else 0)

        if (static_num_patches and not inference_mode and do_patch
                and h % patch_size == 0 and w % patch_size == 0):
            prep = make_static_prep_fn(
                patch_size, int(static_num_patches), rotations=rotations,
                flags_mode="custom" if have_custom else "mad",
                flag_sigma=float(flag_sigma), use_kernels=use_kernels,
                stretch=stretch,
                normalize_before_stretch=normalize_before_stretch,
                normalize_after_stretch=normalize_after_stretch,
                extract=extract, return_patches=False,
            )
            flag_flat = _flatten_waterfalls(self.flags, dev) if have_custom else flat
            b = prep.base(flat, flag_flat)
            self.keep = keep = P.static_select_from_has(b.has, prep.k, generator)
            images, labels, _, self.patch_flags = prep.from_keep(b, keep)
            self._patches = None
            self._patches_thunk = lambda: prep.patches(b, keep)
            self.dataset = ArrayDataset(images, labels, metadata)
            return self.dataset

        patches, _ = _augment_and_patchify(flat, patch_size, rotations, do_patch)
        if have_custom:
            flag_flat = _flatten_waterfalls(self.flags, dev) != 0
            flag_patches, _ = _augment_and_patchify(flag_flat, patch_size,
                                                    rotations, do_patch)
        if not is_complex:
            if normalize_before_stretch:
                patches = P.normalize_by_median(patches)
            if stretch:
                patches = P.apply_stretch(patches, stretch)
            if normalize_after_stretch:
                patches = P.normalize_by_median(patches)

        if inference_mode:
            flag_patches = torch.zeros(patches.shape, dtype=torch.bool, device=dev)
        elif not have_custom:
            mad = ops.mad_flag_patches if use_kernels else ops.mad_flag_patches_plain
            flag_patches = mad(patches.contiguous(), float(flag_sigma))

        n = patches.shape[0]
        if static_num_patches and not inference_mode:
            keep = P.static_select_flagged(flag_patches, int(static_num_patches),
                                           generator)
        else:
            if inference_mode:
                keep = np.arange(n)
            else:
                has = flag_patches.reshape(n, -1).any(dim=1).cpu().numpy()
                if has.any():
                    keep = np.nonzero(has)[0]
                else:
                    logger.warning("No flagged patches found - keeping all patches")
                    keep = np.arange(n)
                rng = np.random.default_rng(seed) if seed is not None else np.random
                keep = rng.permutation(keep)
            if num_patches and num_patches < len(keep):
                keep = keep[:num_patches]
            if pad_to_multiple and not inference_mode and len(keep) % pad_to_multiple:
                deficit = pad_to_multiple - len(keep) % pad_to_multiple
                reps = -(-deficit // max(len(keep), 1))
                keep = np.concatenate([keep, np.tile(keep, reps)[:deficit]])
            keep = torch.as_tensor(keep, dtype=torch.long, device=dev)
        self.keep = keep
        patches = patches[keep]
        flag_patches = flag_patches[keep]

        if use_kernels:
            images = ops.fused_extract_channels(patches.contiguous())
        else:
            images = ops.fused_extract_channels_plain(patches)
        self.patches = patches
        self.patch_flags = flag_patches
        self.dataset = ArrayDataset(images, flag_patches.to(torch.uint8), metadata)
        return self.dataset


class DevicePreprocessor:
    """Raw complex patches and their masks, with the least host work: no
    channel extraction, no ImageNet affine and no materialised
    augmentation (:class:`~rfi_toolbox_tpu_torch.train.raw_patches.RawPatchTrainer`
    draws those on the device at each step).

    >>> raw, masks = DevicePreprocessor(vis, flags).create_raw_patches()

    Args:
        data: complex waterfalls (baselines, pols, channels, times) or
            (pols, channels, times), array or tensor.
        flags: optional flags of the same shape; without them a pixel is
            masked where ``|data| > 0``, as the reference does.
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.
    """

    def __init__(self, data, flags=None, device=None):
        if not hasattr(data, "ndim"):
            data = np.asarray(data)
        if data.ndim == 3:
            data = data[None]
        elif data.ndim != 4:
            raise ValueError(f"Data must be 3D or 4D, got shape {tuple(data.shape)}")
        if not torch.as_tensor(data[:1]).is_complex():
            raise ValueError("DevicePreprocessor requires complex data. "
                             "Use standard Preprocessor for real-valued data.")
        self.data = data
        self.flags = flags
        self.device = device
        self.raw_patches = None
        self.raw_masks = None
        self.original_shapes = None

    def create_raw_patches(self, patch_size=256, remove_blank=True, num_patches=None,
                           num_workers=4, seed=None):
        """Patchify, blank removal and shuffle only: returns ``(patches (N,
        p, p) complex64, masks (N, p, p) bool)`` on the device (a waterfall
        no larger than one patch stays whole).

        The kept indices are the JAX package's for the same ``seed`` (numpy's
        ``default_rng(seed)``, or the global numpy RNG when None): the
        flagged patches (all with ``remove_blank=False``), cut to
        ``num_patches`` by ``rng.choice`` as the reference does, then
        permuted. ``num_workers`` is ignored.
        """
        del num_workers
        dev = resolve_device(self.device)
        flat = _flatten_waterfalls(self.data, dev, torch.complex64)
        if self.flags is not None:
            flag_flat = _flatten_waterfalls(self.flags, dev) != 0
        else:
            flag_flat = P.magnitude(flat) > 0

        h, w = flat.shape[-2:]
        self.original_shapes = [(h, w)] * flat.shape[0]
        if h <= patch_size and w <= patch_size:
            patches, masks = flat, flag_flat
        else:
            patches = P.patchify_batch(flat, patch_size)
            masks = P.patchify_batch(flag_flat, patch_size)

        n = patches.shape[0]
        rng = np.random.default_rng(seed) if seed is not None else np.random
        if remove_blank:
            keep = np.nonzero(masks.reshape(n, -1).any(dim=1).cpu().numpy())[0]
        else:
            keep = np.arange(n)
        if num_patches and num_patches < len(keep):
            keep = np.sort(rng.choice(len(keep), num_patches, replace=False))
        keep = torch.as_tensor(rng.permutation(keep), dtype=torch.long, device=dev)
        self.raw_patches = patches[keep]
        self.raw_masks = masks[keep]
        return self.raw_patches, self.raw_masks

    def estimate_storage_mb(self):
        """The raw patches' size in MiB (0 before :meth:`create_raw_patches`
        or when none was kept)."""
        if self.raw_patches is None or len(self.raw_patches) == 0:
            return 0.0
        return float(self.raw_patches.numel() * self.raw_patches.element_size()) / (1024 * 1024)

    # the reference's private name
    _estimate_storage_mb = estimate_storage_mb


# the reference's name
GPUPreprocessor = DevicePreprocessor
