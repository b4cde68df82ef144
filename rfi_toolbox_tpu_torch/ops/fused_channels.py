"""Channel-extraction kernels on the card: K4, K2, K1 and K3.

Counterparts of ``rfi_toolbox_tpu/ops/fused_channels.py``:

- K4 :func:`fused_extract_channels` (``csrc/channel_planes.cu``): the
  3-channel extraction of gathered patches;
- K2 :func:`fused_extract_channel_planes` (``csrc/channel_planes.cu``):
  the five variant-aware planes of base patches;
- K1 :func:`fused_gather_extract` (``csrc/channel_planes.cu``): the
  extraction fused with the static selection's gather;
- K3 :func:`fused_plane_gather_transform` (``csrc/plane_gather.cu``): the
  plane gather with the variant's flip/transpose.

Each wrapper runs its plain PyTorch version (``*_plain``) for a tensor on
the CPU, and for a CUDA tensor launches its kernel or raises; nothing
falls back. ``*_model`` (K2, K1, K4) is a torch model of the kernel's
passes (the 4-CTA row split with its halo rows, the min and max reduced
across the parts, the reciprocal-and-FMA arithmetic, K1's outputs grouped
by base patch, K4's interleaved channels), for the tests; no path runs it. ``<wrapper>.launches``
counts each kernel's launches. Index ranges are checked on the card without a host sync
(``torch._assert_async``): a bad index stops the process at its next
synchronisation.
"""

import numpy as np
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
    "fused_extract_channels_model",
    "fused_extract_channel_planes_model",
    "fused_gather_extract_model",
    "MAX_PATCH_PIXELS",
]

MAX_PATCH_PIXELS = 128 * 128  # kMaxPixels / kMaxSide^2 in csrc/
CLUSTER = 4  # CTAs that split a patch's rows in K1, K2, K4 (csrc/channel_planes.cu)
LIST_CAP = 64  # K1's outputs of one base patch listed at a time (kListCap in csrc/)


def _check_patches(patches, dtypes):
    if patches.device.type != "cuda":
        raise ValueError(f"unsupported device {patches.device}")
    if patches.dtype not in dtypes:
        raise TypeError(f"expected {' or '.join(map(str, dtypes))}, got {patches.dtype}")
    if patches.ndim != 3:
        raise ValueError(f"expected (N, H, W) patches, got {tuple(patches.shape)}")
    if not patches.is_contiguous():
        raise ValueError("patches must be contiguous")
    _, h, w = patches.shape
    if h * w > MAX_PATCH_PIXELS:
        raise ValueError(
            f"the extraction kernels take patches of at most "
            f"{MAX_PATCH_PIXELS} pixels (128 x 128), got {h} x {w}"
        )


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


def fused_extract_channels_plain(patches):
    """Plain PyTorch version of K4, on any device."""
    return P.imagenet_normalize(P.extract_channels(patches))


def fused_extract_channels(patches):
    """(N, H, W) complex64 or float32 -> (N, H, W, 3) float32,
    ImageNet-normalised [gradient, log_amp, phase].

    A CPU tensor goes through the plain version. A CUDA tensor must be
    contiguous complex64 or float32 with H * W <= 128 * 128.
    """
    if patches.device.type == "cpu":
        return fused_extract_channels_plain(patches)
    _check_patches(patches, (torch.complex64, torch.float32))
    n, h, w = patches.shape
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=patches.device)
    if n == 0:
        return out
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
    contiguous complex64 or float32 with H * W <= 128 * 128.
    """
    if patches.device.type == "cpu":
        return fused_extract_channel_planes_plain(patches)
    _check_patches(patches, (torch.complex64, torch.float32))
    m, h, w = patches.shape
    grad3 = torch.empty((3, m, h, w), dtype=torch.float32, device=patches.device)
    amp = torch.empty((m, h, w), dtype=torch.float32, device=patches.device)
    phase = torch.empty_like(amp)
    if m == 0:
        return grad3, amp, phase
    rc = _lib.load().rfi_fused_extract_channel_planes(
        patches.data_ptr(), grad3.data_ptr(), amp.data_ptr(), phase.data_ptr(),
        m, h, w, int(patches.is_complex()), _lib.stream_of(patches),
    )
    _lib.check(rc, "fused_extract_channel_planes")
    fused_extract_channel_planes.launches += 1
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
    must be contiguous complex64 or float32 with H * W <= 128 * 128, and
    the indices on the same card; each selected base patch is computed
    once, and written to each output that selects it.
    """
    if patches.device.type == "cpu":
        return fused_gather_extract_plain(patches, base_idx, pidx)
    _check_patches(patches, (torch.complex64, torch.float32))
    m, h, w = patches.shape
    k = base_idx.shape[0]
    base_idx = _check_index(base_idx, "base_idx", k, m, patches.device)
    pidx = _check_index(pidx, "pidx", k, 3, patches.device)
    grad = torch.empty((k, h, w), dtype=torch.float32, device=patches.device)
    amp = torch.empty_like(grad)
    phase = torch.empty_like(grad)
    if k == 0:
        return grad, amp, phase
    rc = _lib.load().rfi_fused_gather_extract(
        patches.data_ptr(), base_idx.data_ptr(), pidx.data_ptr(),
        grad.data_ptr(), amp.data_ptr(), phase.data_ptr(), m, k, h, w,
        int(patches.is_complex()), _lib.stream_of(patches),
    )
    _lib.check(rc, "fused_gather_extract")
    fused_gather_extract.launches += 1
    return grad, amp, phase


fused_gather_extract.launches = 0


# The kernels' folded affines (csrc/channel_planes.cu), in float32 as nvcc
# folds the constant expressions.
_F = np.float32
_AMP_SCALE = _F(1) / _F(P.LOG_MAX - P.LOG_MIN)
_AMP_SHIFT = -_F(P.LOG_MIN) / _F(P.LOG_MAX - P.LOG_MIN)
_MEAN, _STD = P.IMAGENET_MEAN, P.IMAGENET_STD
_INV_STD1 = _F(1) / _STD[1]
_SHIFT = -_MEAN / _STD  # affine(0) of each plane
_PHASE_SCALE = _F(1) / (_F(2 * np.pi) * _STD[2])
_PHASE_SHIFT = (_F(0.5) - _MEAN[2]) / _STD[2]


def _fma(a, b, c):
    """fmaf(a, b, c) of float32 tensors, scalars or both: the product is
    exact in float64 and the sum rounded to float64, then to float32 (a
    true FMA can differ by one ulp, in rare ties)."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def _row_parts(h):
    """[r0, r1) of the rows of each CTA of a cluster: ceil(h / 4) rows
    each, the last ones empty where h < 4 or h is not a multiple."""
    rows = -(-h // CLUSTER)
    return [(min(h, r * rows), min(h, (r + 1) * rows)) for r in range(CLUSTER)]


def _nan_skipping_min_max(x):
    """Per-patch min and max of (n, rows, w), NaN skipped (fminf, fmaxf);
    +-inf for a patch of no valid pixel."""
    nan = torch.isnan(x)
    return (torch.where(nan, float("inf"), x).amin(dim=(-2, -1)),
            torch.where(nan, float("-inf"), x).amax(dim=(-2, -1)))


def _norm(x, lo, hi, std, shift):
    """(x - lo) / span and the affine as the kernels compute them:
    (x - lo) * (1 / (span * std)) + shift in one FMA, ``shift`` where
    span is not positive. lo, hi: (n,)."""
    span = (hi - lo)[:, None, None]
    pos = span > 0
    scale = torch.where(pos, 1.0 / torch.where(pos, span * std, 1.0), 0.0)
    return torch.where(pos, _fma(x - lo[:, None, None], scale, shift),
                       torch.full_like(x, float(shift)))


def _cluster_planes(patches, planes=(0, 1, 2)):
    """The model of one cluster per patch of (n, h, w) patches: the
    gradient planes in ``planes`` (a dict), the amplitude and phase
    planes (n, h, w)."""
    n, h, w = patches.shape
    la = torch.log10(P.magnitude(patches) + 1e-10)
    parts = [(r0, r1) for r0, r1 in _row_parts(h) if r1 > r0]
    # pass 2: each part's gradients from its rows and its two halo rows
    grads, lows, highs = [], [], []
    for r0, r1 in parts:
        own = la[:, r0:r1]
        # the halo rows: the last row of the part above, the first of the
        # part below (zeros at the patch's edge, where no difference is taken)
        halo = torch.zeros_like(la[:, :1])
        tile = torch.cat([la[:, r0 - 1:r0] if r0 > 0 else halo, own,
                          la[:, r1:r1 + 1] if r1 < h else halo], dim=1)
        row = torch.arange(r0, r1, device=la.device)[None, :, None]
        td_fwd = torch.where(row > 0, own - tile[:, :-2], 0.0)
        td_down = torch.where(row < h - 1, tile[:, 2:] - own, 0.0)
        zero = torch.zeros_like(own[..., :1])
        fd_fwd = torch.cat([zero, own[..., 1:] - own[..., :-1]], dim=-1)
        fd_down = torch.cat([own[..., 1:] - own[..., :-1], zero], dim=-1)
        g = {0: torch.sqrt(td_fwd * td_fwd + fd_fwd * fd_fwd),
             1: torch.sqrt(td_down * td_down + fd_fwd * fd_fwd),
             2: torch.sqrt(td_fwd * td_fwd + fd_down * fd_down)}
        grads.append({v: g[v] for v in planes})
        lows.append({v: _nan_skipping_min_max(g[v])[0] for v in planes})
        highs.append({v: _nan_skipping_min_max(g[v])[1] for v in planes})
    # the min and max pushed across the cluster, then pass 3
    out = {}
    for v in planes:
        lo = torch.stack([part[v] for part in lows]).amin(dim=0)
        hi = torch.stack([part[v] for part in highs]).amax(dim=0)
        out[v] = torch.cat([_norm(part[v], lo, hi, _STD[0], _SHIFT[0])
                            for part in grads], dim=1)
    if patches.is_complex():
        amp = _fma(torch.clamp(_fma(la, _AMP_SCALE, _AMP_SHIFT), 0.0, 1.0),
                   _INV_STD1, _SHIFT[1])
        phase = _fma(torch.atan2(patches.imag, patches.real).float(),
                     _PHASE_SCALE, _PHASE_SHIFT)
    else:
        part_lo, part_hi = zip(*(_nan_skipping_min_max(la[:, r0:r1])
                                 for r0, r1 in parts))
        amp = _norm(la, torch.stack(part_lo).amin(dim=0),
                    torch.stack(part_hi).amax(dim=0), _STD[1], _SHIFT[1])
        phase = torch.full_like(la, float(-_MEAN[2] / _STD[2]))
    return out, amp, phase


def fused_extract_channels_model(patches):
    """Torch model of K4's passes, on any device: K2's with the fwd/fwd
    gradient plane only, the channels interleaved as (N, H, W, 3); the
    same outputs as :func:`fused_extract_channels`."""
    grads, amp, phase = _cluster_planes(patches, planes=(0,))
    return torch.stack([grads[0], amp, phase], dim=-1)


def fused_extract_channel_planes_model(patches):
    """Torch model of K2's passes (see the module docstring), on any
    device: the same outputs as :func:`fused_extract_channel_planes`."""
    grads, amp, phase = _cluster_planes(patches)
    return torch.stack([grads[v] for v in range(3)]), amp, phase


def fused_gather_extract_model(patches, base_idx, pidx):
    """Torch model of K1's passes, on any device: each base patch's
    outputs found by a scan of ``base_idx`` in order (as each cluster of
    the kernel finds its own); each selected base patch computed once,
    with only the gradient planes its outputs select; each output written
    from it. An output that no scan reaches stays NaN."""
    m, h, w = patches.shape
    k = base_idx.shape[0]
    outs = tuple(torch.full((k, h, w), float("nan"), device=patches.device)
                 for _ in range(3))
    for b in range(m):
        js = torch.nonzero(base_idx == b).flatten().tolist()
        if not js:
            continue
        vs = [int(pidx[j]) for j in js]
        grads, amp, phase = _cluster_planes(patches[b:b + 1], sorted(set(vs)))
        for j, v in zip(js, vs):
            outs[0][j], outs[1][j], outs[2][j] = grads[v][0], amp[0], phase[0]
    return outs


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
        variant's orientation.

    CPU tensors go through the plain version. On the card the planes
    must be contiguous float32 with h <= 128, and the indices on the same
    card.
    """
    grad3, log_amp, phase = planes
    if grad3.device.type == "cpu":
        return fused_plane_gather_transform_plain(planes, base_idx, pidx, variant)
    m, h, w = log_amp.shape
    if h != w:
        raise ValueError("the variant transform requires square patches")
    for name, x, shape in (("grad3", grad3, (3, m, h, w)),
                           ("log_amp", log_amp, (m, h, w)),
                           ("phase", phase, (m, h, w))):
        if x.device != log_amp.device or x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {log_amp.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got "
                             f"{tuple(x.shape)}")
    _check_patches(log_amp, (torch.float32,))
    k = base_idx.shape[0]
    base_idx = _check_index(base_idx, "base_idx", k, m, log_amp.device)
    pidx = _check_index(pidx, "pidx", k, 3, log_amp.device)
    variant = _check_index(variant, "variant", k, 4, log_amp.device)
    outs = tuple(torch.empty((k, h, w), dtype=torch.float32,
                             device=log_amp.device) for _ in range(3))
    if k == 0 or m == 0:
        return outs
    rc = _lib.load().rfi_fused_plane_gather_transform(
        grad3.data_ptr(), log_amp.data_ptr(), phase.data_ptr(),
        base_idx.data_ptr(), pidx.data_ptr(), variant.data_ptr(),
        *(o.data_ptr() for o in outs), m, k, h, _lib.stream_of(log_amp),
    )
    _lib.check(rc, "fused_plane_gather_transform")
    fused_plane_gather_transform.launches += 1
    return outs


fused_plane_gather_transform.launches = 0
