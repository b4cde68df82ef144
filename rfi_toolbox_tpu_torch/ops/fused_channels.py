"""Channel-extraction kernels on the card: K4, K2, K1 and K3.

Counterparts of ``rfi_toolbox_tpu/ops/fused_channels.py``:

- K4 :func:`fused_extract_channels`: the 3-channel extraction of
  gathered patches;
- K2 :func:`fused_extract_channel_planes`: the five variant-aware planes
  of base patches;
- K1 :func:`fused_gather_extract`: the extraction fused with the static
  selection's gather;
- K3 :func:`fused_plane_gather_transform` (``csrc/plane_gather.cu``): the
  plane gather with the variant's flip/transpose, as three planes or, by
  :func:`fused_plane_gather_transform_images`, as channels-last images
  (also the variant transform alone of K1's planes).

Each takes patches of any H x W; :func:`extract_route` picks K4's, K2's
and K1's kernel by the shape alone:

- up to ``CLUSTER_MAX_PIXELS`` (128 x 128) pixels the cluster kernel
  (``csrc/channel_planes.cu``: a patch split across a cluster of 4 CTAs);
- larger patches whose slabs fit the resident grid the resident-group
  kernel (``csrc/extract_groups.cu``: one launch; a patch cut into G slabs
  of whole rows, each held in one CTA's shared memory, ``GROUP_SMEM_BYTES``
  with its two halo rows, while all G are held at once (a cooperative
  launch, so other streams' kernels cannot keep part of the grid out), so
  G may not exceed the CTAs resident on the card; the input read once,
  every output written once, K1 straight into its outputs), where a slab
  holds the kind's ``GROUP_MIN_ROWS`` rows: for K4 8 (complex patches up
  to 691 wide, real ones up to 1382 wide), for K2 and K1 1 (with 4 x 132
  CTAs resident, complex 1024 x 1024 patches at 4 rows a slab; not
  2048 x 2048);
- the rest (K4 on complex 1024 x 1024 patches among them) the two-pass
  strip kernel (``csrc/extract_strips.cu``: three launches over 16 x 128
  tiles, a patch's min and max combined by atomics), K1 as the strip K2
  into a scratch of planes, then K3's gather.

K3 is one kernel for every tile size: a CTA owns squares of 32 x 32 of the
selected base patches, reads each once (TMA) and writes it to every output
that selects it.

Each wrapper runs its plain PyTorch version (``*_plain``) for a tensor on
the CPU, and for a CUDA tensor launches its kernel or raises; nothing
falls back. ``<wrapper>.launches`` counts each kernel's launches (K3's
both wrappers in ``fused_plane_gather_transform.launches``). Index
ranges are checked on the card without a host sync (K1's by
``torch._assert_async``, K3's inside its kernel, which traps): a bad
index stops the process at its next synchronisation. Torch models of the
kernels' passes, which hold their arithmetic against the plain versions
on the CPU, live with the tests (``tests/torch_kernel_models.py``).
"""

import ctypes
import functools

import torch

from ..preprocess import pipeline as P
from . import _lib

__all__ = [
    "fused_extract_channels",
    "fused_extract_channels_plain",
    "fused_extract_channel_planes",
    "fused_extract_channel_planes_plain",
    "fused_gather_extract",
    "fused_gather_extract_plain",
    "fused_plane_gather_transform",
    "fused_plane_gather_transform_plain",
    "fused_plane_gather_transform_images",
    "fused_plane_gather_transform_images_plain",
    "extract_route",
    "group_rows",
    "CLUSTER_MAX_PIXELS",
    "GROUP_SMEM_BYTES",
]

# patches up to this many pixels take the cluster kernel (kMaxPixels in
# csrc/channel_planes.cu)
CLUSTER_MAX_PIXELS = 128 * 128
# the shared memory of a slab of the resident-group kernel with its two halo
# rows, at most (kSmemBudget in csrc/extract_groups.cu)
GROUP_SMEM_BYTES = 54 * 1024
# the rows of a slab where the shape allows (fewer where its shared memory
# holds fewer, more where a patch's slabs would outnumber the resident CTAs)
GROUP_ROWS = 16
# the kernels' kinds (kK2, kK1, kK4 in csrc/channel_planes.cu,
# extract_groups.cu and extract_strips.cu)
_K2, _K1, _K4 = 0, 1, 2
# the fewest rows a slab of the resident-group kernel may have, by kind. K4
# writes all of its output after the wait for the patch's other slabs, and at
# 4 rows a slab (1024-wide complex patches) the halo rows converted again
# cost more than the strip kernel's second read: 2.57 against 2.05 ms at
# (128, 1024, 1024) on the H100; K2 (0.188 against 0.200 ms at (8, 1024,
# 1024)) and K1 (0.299 against the strip K2 and K3's 0.577) gain at any
# height (PERF.md)
GROUP_MIN_ROWS = {_K4: 8, _K2: 1, _K1: 1}


def group_rows(h, w, is_complex, resident):
    """The rows of a slab of the resident-group kernel for patches of ``h``
    x ``w``, or 0 where none fits.

    ``resident`` is the count of that kernel's CTAs the card holds at once
    (``rfi_extract_groups_occupancy``). The kernel holds all G = ceil(h /
    rows) slabs of a patch at once, so ``rows`` must keep G <= ``resident``
    and a slab with its two halo rows within ``GROUP_SMEM_BYTES``. Of those,
    the nearest to ``GROUP_ROWS``, evened out over the patch's G slabs.
    """
    most = GROUP_SMEM_BYTES // (w * (8 if is_complex else 4)) - 2
    least = -(-h // resident)
    if most < max(least, 1):
        return 0
    rows = min(most, max(least, GROUP_ROWS))
    return -(-h // -(-h // rows))


def extract_route(kind, h, w, is_complex, resident):
    """The kernel that K4 (``kind`` ``_K4``), K2 or K1 runs on patches of
    ``h`` x ``w``: ``("cluster", 0)`` up to ``CLUSTER_MAX_PIXELS`` pixels,
    else ``("groups", rows)`` where :func:`group_rows` cuts a patch into no
    more slabs than the kind's ``GROUP_MIN_ROWS`` rows a slab would, else
    ``("strips", 0)``."""
    if h * w <= CLUSTER_MAX_PIXELS:
        return "cluster", 0
    rows = group_rows(h, w, is_complex, resident)
    if rows and -(-h // rows) <= -(-h // GROUP_MIN_ROWS[kind]):
        return "groups", rows
    return "strips", 0


@functools.cache
def _resident(device, kind, is_complex):
    """CTAs of the resident-group kernel of ``kind`` that the current card
    holds at once (once per device)."""
    fit = (ctypes.c_int * 3)()
    _lib.check(_lib.load().rfi_extract_groups_occupancy(kind, int(is_complex), fit),
               "extract_groups_occupancy")
    return fit[1]


def _route(kind, patches):
    _, h, w = patches.shape
    if h * w <= CLUSTER_MAX_PIXELS:
        return "cluster", 0
    resident = _resident(torch.cuda.current_device(), kind, patches.is_complex())
    return extract_route(kind, h, w, patches.is_complex(), resident)


def _check_patches(patches, dtypes):
    if patches.device.type != "cuda":
        raise ValueError(f"unsupported device {patches.device}")
    if patches.dtype not in dtypes:
        raise TypeError(f"expected {' or '.join(map(str, dtypes))}, got {patches.dtype}")
    if patches.ndim != 3:
        raise ValueError(f"expected (N, H, W) patches, got {tuple(patches.shape)}")
    if not patches.is_contiguous():
        raise ValueError("patches must be contiguous")


def _check_index(idx, name, k, bound, device):
    """(k,) integer index tensor on ``device`` with values in [0, bound)
    -> contiguous int32; the range is asserted on the card."""
    if idx.device != device:
        raise ValueError(f"{name} is on {idx.device}, the planes on {device}")
    if idx.dtype not in (torch.int32, torch.int64) or tuple(idx.shape) != (k,):
        raise ValueError(f"{name} must be ({k},) int32 or int64, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    torch._assert_async(((idx >= 0) & (idx < bound)).all(),
                        f"{name} out of range [0, {bound})")
    return idx.to(torch.int32).contiguous()


def _extract_strips(kind, patches, out, amp=None, phase=None):
    """Launch the strip kernel (csrc/extract_strips.cu) of kind ``_K4``
    (``out`` (N, H, W, 3)) or ``_K2`` (``out`` = grad3, ``amp``,
    ``phase``) on checked, non-empty patches, with a scratch of 8 keys a
    patch."""
    n, h, w = patches.shape
    keys = torch.empty((n, 8), dtype=torch.int32, device=patches.device)
    rc = _lib.load().rfi_extract_strips(
        kind, patches.data_ptr(), out.data_ptr(),
        None if amp is None else amp.data_ptr(),
        None if phase is None else phase.data_ptr(), keys.data_ptr(), n, h, w,
        int(patches.is_complex()), _lib.stream_of(patches),
    )
    _lib.check(rc, "extract_strips")


def _extract_groups(kind, patches, rows, out, amp=None, phase=None, base_idx=None,
                    pidx=None):
    """Launch the resident-group kernel (csrc/extract_groups.cu) of kind
    ``_K4`` (``out`` (N, H, W, 3)), ``_K2`` (``out`` = grad3, ``amp``,
    ``phase``) or ``_K1`` (``out`` = grad, ``amp``, ``phase`` of the K
    outputs of int32 ``base_idx``, ``pidx``) on checked, non-empty patches,
    slabs of ``rows`` rows, with a scratch of 9 words a patch. The launch is
    cooperative: it raises where the grid cannot be held at once."""
    n, h, w = patches.shape
    k = 0 if base_idx is None else base_idx.shape[0]
    scratch = torch.empty(1 + 9 * n, dtype=torch.int32, device=patches.device)
    rc = _lib.load().rfi_extract_groups(
        kind, patches.data_ptr(), *(None if x is None else x.data_ptr()
                                    for x in (base_idx, pidx, out, amp, phase)),
        scratch.data_ptr(), n, k, h, w, rows, int(patches.is_complex()),
        _lib.stream_of(patches),
    )
    _lib.check(rc, "extract_groups")


def fused_extract_channels_plain(patches):
    """Plain PyTorch version of K4, on any device."""
    return P.imagenet_normalize(P.extract_channels(patches))


def fused_extract_channels(patches):
    """(N, H, W) complex64 or float32 -> (N, H, W, 3) float32,
    ImageNet-normalised [gradient, log_amp, phase].

    A CPU tensor goes through the plain version. A CUDA tensor must be
    contiguous complex64 or float32; it takes the kernel that
    :func:`extract_route` picks for its shape.
    """
    if patches.device.type == "cpu":
        return fused_extract_channels_plain(patches)
    _check_patches(patches, (torch.complex64, torch.float32))
    n, h, w = patches.shape
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=patches.device)
    if n == 0:
        return out
    route, rows = _route(_K4, patches)
    if route == "groups":
        _extract_groups(_K4, patches, rows, out)
    elif route == "strips":
        _extract_strips(_K4, patches, out)
    else:
        rc = _lib.load().rfi_fused_extract_channels(
            patches.data_ptr(), out.data_ptr(), n, h, w,
            int(patches.is_complex()), _lib.stream_of(patches),
        )
        _lib.check(rc, "fused_extract_channels")
    fused_extract_channels.launches += 1
    return out


fused_extract_channels.launches = 0


def fused_extract_channel_planes_plain(patches):
    """Plain PyTorch version of K2, on any device."""
    return P.extract_channel_planes(patches)


def fused_extract_channel_planes(patches):
    """(M, H, W) complex64 or float32 base patches -> ``(grad3 (3, M, H,
    W), log_amp (M, H, W), phase (M, H, W))`` float32, ImageNet-normalised
    (see :func:`..preprocess.pipeline.extract_channel_planes`; real input
    gets the min-max log-amplitude and a zero phase).

    A CPU tensor goes through the plain version. A CUDA tensor must be
    contiguous complex64 or float32; it takes the kernel that
    :func:`extract_route` picks for its shape.
    """
    if patches.device.type == "cpu":
        return fused_extract_channel_planes_plain(patches)
    _check_patches(patches, (torch.complex64, torch.float32))
    planes = _planes_of(patches)
    if patches.shape[0]:
        fused_extract_channel_planes.launches += 1
    return planes


def _planes_of(patches):
    """K2's planes of checked patches on the card, by the kernel their
    size takes (no launch for an empty batch)."""
    m, h, w = patches.shape
    grad3 = torch.empty((3, m, h, w), dtype=torch.float32, device=patches.device)
    amp = torch.empty((m, h, w), dtype=torch.float32, device=patches.device)
    phase = torch.empty_like(amp)
    if m == 0:
        return grad3, amp, phase
    route, rows = _route(_K2, patches)
    if route == "groups":
        _extract_groups(_K2, patches, rows, grad3, amp, phase)
    elif route == "strips":
        _extract_strips(_K2, patches, grad3, amp, phase)
    else:
        rc = _lib.load().rfi_fused_extract_channel_planes(
            patches.data_ptr(), grad3.data_ptr(), amp.data_ptr(), phase.data_ptr(),
            m, h, w, int(patches.is_complex()), _lib.stream_of(patches),
        )
        _lib.check(rc, "fused_extract_channel_planes")
    return grad3, amp, phase


fused_extract_channel_planes.launches = 0


def _gather_planes(planes, base_idx, pidx):
    """Planes of M base patches -> the three planes of the K selected
    ones: the gradient plane ``pidx`` of base patch ``base_idx``, and its
    log-amplitude and phase planes."""
    grad3, log_amp, phase = planes
    m = log_amp.shape[0]
    grad = grad3.reshape(3 * m, *grad3.shape[2:])[pidx.long() * m + base_idx.long()]
    return grad, log_amp[base_idx.long()], phase[base_idx.long()]


def fused_gather_extract_plain(patches, base_idx, pidx):
    """Plain PyTorch version of K1, on any device: the planes of every
    base patch, then the gather."""
    return _gather_planes(P.extract_channel_planes(patches), base_idx, pidx)


def fused_gather_extract(patches, base_idx, pidx):
    """Gather and variant-aware extraction in one pass.

    Args:
        patches: (M, H, W) complex64 or float32 base patches.
        base_idx: (K,) int base-patch index of each output.
        pidx: (K,) int gradient plane of each output (0 = fwd/fwd,
            1 = down/fwd, 2 = fwd/down).

    Returns:
        ``(grad, log_amp, phase)``, each (K, H, W) float32 and
        ImageNet-normalised, in the base orientation (the caller applies
        the variant's flip/transpose); real input gets the min-max
        log-amplitude and a zero phase.

    A CPU tensor goes through the plain version. On the card the patches
    must be contiguous complex64 or float32, and the indices on the same
    card; :func:`extract_route` picks the kernel by the shape. The cluster
    and the resident-group kernels compute each selected base patch once,
    and write it to each output that selects it (a base patch that nothing
    selects is not read). The strip route computes the strip kernel's K2
    planes of every base patch, in a scratch of 20 B a base pixel, then K3's
    gather of the selected planes (variant 0, no flip or transpose).
    """
    if patches.device.type == "cpu":
        return fused_gather_extract_plain(patches, base_idx, pidx)
    _check_patches(patches, (torch.complex64, torch.float32))
    m, h, w = patches.shape
    k = base_idx.shape[0]
    base_idx = _check_index(base_idx, "base_idx", k, m, patches.device)
    pidx = _check_index(pidx, "pidx", k, 3, patches.device)
    out = torch.empty((3, k, h, w), dtype=torch.float32, device=patches.device)
    grad, amp, phase = out
    if k == 0:
        return grad, amp, phase
    route, rows = _route(_K1, patches)
    if route == "groups":
        _extract_groups(_K1, patches, rows, grad, amp, phase, base_idx, pidx)
    elif route == "strips":
        planes = _planes_of(patches)
        variant = torch.zeros(k, dtype=torch.int32, device=patches.device)
        _gather_transform(planes, base_idx, pidx, variant, out, 1)
    else:
        rc = _lib.load().rfi_fused_gather_extract(
            patches.data_ptr(), base_idx.data_ptr(), pidx.data_ptr(),
            grad.data_ptr(), amp.data_ptr(), phase.data_ptr(), m, k, h, w,
            int(patches.is_complex()), _lib.stream_of(patches),
        )
        _lib.check(rc, "fused_gather_extract")
    fused_gather_extract.launches += 1
    return grad, amp, phase


fused_gather_extract.launches = 0


def fused_plane_gather_transform_plain(planes, base_idx, pidx, variant):
    """Plain PyTorch version of K3, on any device."""
    from ..preprocess.static_prep import transform_by_variant

    return tuple(transform_by_variant(x, variant)
                 for x in _gather_planes(planes, base_idx, pidx))


def fused_plane_gather_transform(planes, base_idx, pidx, variant):
    """Gather the selected channel planes and apply each output's variant
    flip/transpose, in one pass; bit-equal to the plain version.

    Args:
        planes: ``(grad3 (3, M, h, h), log_amp (M, h, h), phase
            (M, h, h))`` float32, as :func:`fused_extract_channel_planes`
            returns them; square tiles.
        base_idx: (K,) int base-patch index of each output.
        pidx: (K,) int gradient plane of each output.
        variant: (K,) int variant id [orig, flipud, T, flipud.T].

    Returns:
        ``(grad, log_amp, phase)``, each (K, h, h) float32 in the
        variant's orientation (contiguous views of one (3, K, h, h)
        buffer).

    CPU tensors go through the plain version. On the card the planes
    must be contiguous float32 and the indices int32 or int64 on the same
    card; their ranges are checked in the kernel, which traps on a bad
    index (the process stops at its next synchronisation).
    """
    if planes[0].device.type == "cpu":
        return fused_plane_gather_transform_plain(planes, base_idx, pidx, variant)
    m, h, w = _check_gather_planes(planes, 3)
    k = variant.shape[0]
    idx = _gather_indices(k, planes[1].device, base_idx, pidx, variant)
    out = torch.empty((3, k, h, w), dtype=torch.float32, device=planes[1].device)
    if k:
        _gather_transform(planes, *idx, out, 1)
        fused_plane_gather_transform.launches += 1
    return out[0], out[1], out[2]


fused_plane_gather_transform.launches = 0


def fused_plane_gather_transform_images_plain(planes, base_idx, pidx, variant):
    """Plain PyTorch version of :func:`fused_plane_gather_transform_images`,
    on any device."""
    from ..preprocess.static_prep import transform_by_variant_nhwc

    if base_idx is None:
        return transform_by_variant_nhwc(torch.stack(planes, dim=-1), variant)
    return torch.stack(fused_plane_gather_transform_plain(planes, base_idx, pidx, variant),
                       dim=-1)


def fused_plane_gather_transform_images(planes, base_idx, pidx, variant):
    """K3 into channels-last images: :func:`fused_plane_gather_transform`'s
    three planes written as one (K, h, h, 3) float32 tensor in the same
    launch (no stack). With ``base_idx`` and ``pidx`` None, ``planes`` are
    the three (K, h, h) planes of K outputs (K1's), and output i is their
    patch i in ``variant[i]`` (the variant transform alone).

    CPU tensors go through the plain version (a stack, and in the second
    form :func:`..preprocess.static_prep.transform_by_variant_nhwc`). On
    the card as :func:`fused_plane_gather_transform`; the launch counts in
    ``fused_plane_gather_transform.launches``.
    """
    if planes[0].device.type == "cpu":
        return fused_plane_gather_transform_images_plain(planes, base_idx, pidx, variant)
    if (base_idx is None) != (pidx is None):
        raise ValueError("base_idx and pidx are both given or both None")
    if base_idx is None:
        m, h, w = _check_gather_planes(planes, 0)
        if variant.shape[:1] != (m,):
            raise ValueError(f"variant must be ({m},), got {tuple(variant.shape)}")
    else:
        m, h, w = _check_gather_planes(planes, 3)
    k = variant.shape[0]
    idx = _gather_indices(k, planes[1].device, base_idx, pidx, variant)
    out = torch.empty((k, h, w, 3), dtype=torch.float32, device=planes[1].device)
    if k:
        _gather_transform(planes, *idx, out, 3)
        fused_plane_gather_transform.launches += 1
    return out


def _check_gather_planes(planes, n_grad):
    """K3's planes on the card: grad3 (``n_grad``, M, h, w), or (M, h, w)
    where ``n_grad`` is 0, log_amp and phase (M, h, w), contiguous float32
    on one device, h == w. Returns (M, h, w)."""
    grad3, log_amp, phase = planes
    _check_patches(log_amp, (torch.float32,))
    m, h, w = log_amp.shape
    if h != w:
        raise ValueError("the variant transform requires square patches")
    grad_shape = (n_grad, m, h, w) if n_grad else (m, h, w)
    for name, x, shape in (("grad", grad3, grad_shape), ("phase", phase, (m, h, w))):
        if x.device != log_amp.device or x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {log_amp.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got {tuple(x.shape)}")
    return m, h, w


def _gather_indices(k, device, *indices):
    """K3's (K,) int32 or int64 indices on ``device`` (None kept), as one
    dtype and contiguous. Their ranges are checked in the kernel."""
    given = [x for x in indices if x is not None]
    for x in given:
        if x.device != device:
            raise ValueError(f"an index is on {x.device}, the planes on {device}")
        if x.dtype not in (torch.int32, torch.int64) or tuple(x.shape) != (k,):
            raise ValueError(f"indices must be ({k},) int32 or int64, got "
                             f"{tuple(x.shape)} {x.dtype}")
    dtype = torch.int64 if any(x.dtype == torch.int64 for x in given) else torch.int32
    return [None if x is None else x.to(dtype).contiguous() for x in indices]


def _gather_transform(planes, base_idx, pidx, variant, out, stride):
    """Launch K3 on checked planes (M, h, w) and indices of one dtype into
    ``out``: (3, K, h, w) planes (``stride`` 1) or (K, h, w, 3) images (3);
    ``base_idx`` and ``pidx`` None for the variant transform of K = M
    patches. A transposing variant needs h == w (the kernel traps)."""
    grad3, log_amp, phase = planes
    m, h, w = log_amp.shape
    rc = _lib.load().rfi_fused_plane_gather_transform(
        grad3.data_ptr(), log_amp.data_ptr(), phase.data_ptr(),
        None if base_idx is None else base_idx.data_ptr(),
        None if pidx is None else pidx.data_ptr(), variant.data_ptr(), out.data_ptr(),
        m, variant.shape[0], h, w, stride, int(variant.dtype == torch.int64),
        _lib.stream_of(log_amp),
    )
    _lib.check(rc, "fused_plane_gather_transform")
