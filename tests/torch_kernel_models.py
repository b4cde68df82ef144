"""Torch models of the passes of the port's extraction kernels, for the
tests: each reproduces a kernel's order of work and float32 arithmetic in
plain torch, so that the CPU tests can hold that arithmetic against the
plain versions and the JAX package where the kernels themselves cannot run.

- the cluster kernel (``rfi_toolbox_tpu_torch/ops/csrc/channel_planes.cu``)
  of K2, K1 and K4: the 4-CTA row split with its halo rows, the min and max
  reduced across the parts, the reciprocal-and-FMA arithmetic, K1's outputs
  grouped by base patch, K4's interleaved channels;
- the strip kernel (``csrc/extract_strips.cu``) of K4 and K2 above
  128 x 128: the tiles with their halo row and column, the min and max
  combined as order-preserving integer keys;
- the resident-group kernel (``csrc/extract_groups.cu``) of K4, K2 and K1
  above 128 x 128: slabs of whole rows with their halo rows, each slab's
  min and max combined into the patch's as integer keys (a min as the
  key's complement), K1's outputs written from each selected base patch;
- K3 (``csrc/plane_gather.cu``): each CTA's range of (base patch, 32 x 32
  square) units, the scan of ``base_idx`` for a patch's outputs with its
  ring of list slots, the squares in the 128-byte swizzle, the lanes of its
  16-byte path (4 x 4 transposes by shuffles) and of its per-pixel path,
  the mirrored output squares and the pixel stride.

No path of the package runs these.
"""

import numpy as np
import torch

from rfi_toolbox_tpu_torch.preprocess import pipeline as P

CLUSTER = 4  # CTAs that split a patch's rows in K1, K2, K4 (csrc/channel_planes.cu)
LIST_CAP = 64  # K1's outputs of one base patch listed at a time (kListCap in csrc/)
STRIP_ROWS, STRIP_COLS = 16, 128  # a strip kernel tile (kTileRows, kTileCols)
GATHER_SIDE = 32  # K3's squares (kSide in csrc/plane_gather.cu)
GATHER_THREADS = 256  # its CTA (kThreads)
GATHER_STAGES = 2  # its squares in flight (kStages)

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


def _order_key(x):
    """The strip kernel's order-preserving uint32 key of each float32 (as
    int64): the bits with the sign bit set for x >= +0, all bits flipped
    for x <= -0."""
    bits = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >= 2 ** 31, ~bits & 0xFFFFFFFF, bits | 2 ** 31)


def _key_value(key):
    """Inverse of :func:`_order_key`."""
    bits = torch.where(key >= 2 ** 31, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(
        torch.float32)


def _sqrt(x):
    """The correctly rounded float32 square root (``__fsqrt_rn``)."""
    return torch.sqrt(x.double()).float()


def fused_extract_strips_model(patches, kind):
    """Torch model of the strip kernel's passes (csrc/extract_strips.cu),
    on any device: ``kind`` "K4" returns :func:`fused_extract_channels`'
    output, "K2" :func:`fused_extract_channel_planes`'.

    Each 16 x 128 tile takes log10|x| of its pixels and of one halo row
    and column (zero outside the patch, where no difference is taken).
    Pass 1 reduces each tile's min and max of the squared gradients (and
    of real input's log-amplitude), NaN skipped, and combines them into
    the patch's as order-preserving integer keys (atomicMin, atomicMax);
    pass 2 normalises each tile's gradient roots by the roots of the
    patch's least and largest squares, with the reciprocal-and-FMA
    arithmetic of the cluster kernel."""
    planes = (0,) if kind == "K4" else (0, 1, 2)
    n, h, w = patches.shape
    dev = patches.device
    la = torch.log10(P.magnitude(patches) + 1e-10)
    halo = torch.nn.functional.pad(la, (1, 1, 1, 1))
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    tiles = [(r0, min(h, r0 + STRIP_ROWS), c0, min(w, c0 + STRIP_COLS))
             for r0 in range(0, h, STRIP_ROWS) for c0 in range(0, w, STRIP_COLS)]

    def tile_squares(r0, r1, c0, c1):
        t = halo[:, r0:r1 + 2, c0:c1 + 2]
        own = t[:, 1:-1, 1:-1]
        r, c = rows[:, r0:r1], cols[..., c0:c1]
        td_fwd = torch.where(r > 0, own - t[:, :-2, 1:-1], 0.0)
        td_down = torch.where(r < h - 1, t[:, 2:, 1:-1] - own, 0.0)
        fd_fwd = torch.where(c > 0, own - t[:, 1:-1, :-2], 0.0)
        fd_down = torch.where(c < w - 1, t[:, 1:-1, 2:] - own, 0.0)
        tf2, ff2 = td_fwd * td_fwd, fd_fwd * fd_fwd
        g = {0: tf2 + ff2, 1: td_down * td_down + ff2, 2: tf2 + fd_down * fd_down}
        return {v: g[v] for v in planes}, own

    # pass 1: the keys of each patch's min (all ones at first) and max (0)
    lo_key = torch.full((n, 4), 2 ** 32 - 1, dtype=torch.int64, device=dev)
    hi_key = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    for r0, r1, c0, c1 in tiles:
        squares, own = tile_squares(r0, r1, c0, c1)
        if not patches.is_complex():
            squares[3] = own
        for s, x in squares.items():
            lo, hi = _nan_skipping_min_max(x)
            lo_key[:, s] = torch.minimum(lo_key[:, s], _order_key(lo))
            hi_key[:, s] = torch.maximum(hi_key[:, s], _order_key(hi))
    lo, hi = _key_value(lo_key), _key_value(hi_key)
    lo[:, :3], hi[:, :3] = _sqrt(lo[:, :3]), _sqrt(hi[:, :3])

    # pass 2
    grads = {v: torch.empty((n, h, w), device=dev) for v in planes}
    amp = torch.empty((n, h, w), device=dev)
    for r0, r1, c0, c1 in tiles:
        squares, own = tile_squares(r0, r1, c0, c1)
        for v in planes:
            grads[v][:, r0:r1, c0:c1] = _norm(_sqrt(squares[v]), lo[:, v], hi[:, v],
                                              _STD[0], _SHIFT[0])
        if patches.is_complex():
            amp[:, r0:r1, c0:c1] = _fma(torch.clamp(_fma(own, _AMP_SCALE, _AMP_SHIFT),
                                                    0.0, 1.0), _INV_STD1, _SHIFT[1])
        else:
            amp[:, r0:r1, c0:c1] = _norm(own, lo[:, 3], hi[:, 3], _STD[1], _SHIFT[1])
    if patches.is_complex():
        phase = _fma(torch.atan2(patches.imag, patches.real).float(),
                     _PHASE_SCALE, _PHASE_SHIFT)
    else:
        phase = torch.full_like(la, float(-_MEAN[2] / _STD[2]))
    if kind == "K4":
        return torch.stack([grads[0], amp, phase], dim=-1)
    return torch.stack([grads[v] for v in planes]), amp, phase


def _group_planes(patches, rows, planes):
    """The resident-group kernel's passes on (n, h, w) patches cut into
    slabs of ``rows`` rows: the gradient planes in ``planes`` (a dict),
    the amplitude and phase planes (n, h, w)."""
    n, h, w = patches.shape
    dev = patches.device
    la = torch.log10(P.magnitude(patches) + 1e-10)
    slabs = [(r0, min(h, r0 + rows)) for r0 in range(0, h, rows)]
    zero_row = torch.zeros_like(la[:, :1])

    def slab_squares(r0, r1):
        # the tile: the slab's rows and its halo rows, a zero row where the
        # patch ends (no difference is taken there)
        tile = torch.cat([la[:, r0 - 1:r0] if r0 > 0 else zero_row, la[:, r0:r1],
                          la[:, r1:r1 + 1] if r1 < h else zero_row], dim=1)
        own = tile[:, 1:-1]
        row = torch.arange(r0, r1, device=dev)[None, :, None]
        td_fwd = torch.where(row > 0, own - tile[:, :-2], 0.0)
        td_down = torch.where(row < h - 1, tile[:, 2:] - own, 0.0)
        zero = torch.zeros_like(own[..., :1])
        fd_fwd = torch.cat([zero, own[..., 1:] - own[..., :-1]], dim=-1)
        fd_down = torch.cat([own[..., 1:] - own[..., :-1], zero], dim=-1)
        tf2, ff2 = td_fwd * td_fwd, fd_fwd * fd_fwd
        g = {0: tf2 + ff2, 1: td_down * td_down + ff2, 2: tf2 + fd_down * fd_down}
        return {v: g[v] for v in planes}, own

    # pass A: each slab's min and max into the patch's keys, all zero at
    # first: atomicMax of the min's complement and of the max
    lo_key = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    hi_key = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    for r0, r1 in slabs:
        squares, own = slab_squares(r0, r1)
        if not patches.is_complex():
            squares[3] = own
        for s, x in squares.items():
            lo, hi = _nan_skipping_min_max(x)
            lo_key[:, s] = torch.maximum(lo_key[:, s], ~_order_key(lo) & 0xFFFFFFFF)
            hi_key[:, s] = torch.maximum(hi_key[:, s], _order_key(hi))
    lo, hi = _key_value(~lo_key & 0xFFFFFFFF), _key_value(hi_key)
    lo[:, :3], hi[:, :3] = _sqrt(lo[:, :3]), _sqrt(hi[:, :3])

    # pass B: each slab's roots normalised by the patch's min and max
    grads = {v: torch.empty((n, h, w), device=dev) for v in planes}
    amp = torch.empty((n, h, w), device=dev)
    for r0, r1 in slabs:
        squares, own = slab_squares(r0, r1)
        for v in planes:
            grads[v][:, r0:r1] = _norm(_sqrt(squares[v]), lo[:, v], hi[:, v], _STD[0],
                                       _SHIFT[0])
        if patches.is_complex():
            amp[:, r0:r1] = _fma(torch.clamp(_fma(own, _AMP_SCALE, _AMP_SHIFT), 0.0, 1.0),
                                 _INV_STD1, _SHIFT[1])
        else:
            amp[:, r0:r1] = _norm(own, lo[:, 3], hi[:, 3], _STD[1], _SHIFT[1])
    if patches.is_complex():
        phase = _fma(torch.atan2(patches.imag, patches.real).float(),
                     _PHASE_SCALE, _PHASE_SHIFT)
    else:
        phase = torch.full_like(la, float(-_MEAN[2] / _STD[2]))
    return grads, amp, phase


def fused_extract_groups_model(patches, kind, rows, base_idx=None, pidx=None):
    """Torch model of the resident-group kernel's passes
    (csrc/extract_groups.cu) on slabs of ``rows`` rows, on any device:
    ``kind`` "K4" returns :func:`fused_extract_channels`' output, "K2"
    :func:`fused_extract_channel_planes`', "K1" (with ``base_idx`` and
    ``pidx``) :func:`fused_gather_extract`'.

    Each slab takes log10|x| of its rows and of its halo rows (a zero row
    where the patch ends). Pass A reduces the slab's min and max of the
    squared gradients (and of real input's log-amplitude), NaN skipped,
    and combines them into the patch's as integer keys; pass B normalises
    the slab's gradient roots by the roots of the patch's least and
    largest squares, with the cluster kernel's reciprocal-and-FMA
    arithmetic. K1 finds each base patch's outputs by a scan of
    ``base_idx`` in order, computes a selected base patch once with the
    gradient planes its outputs select, and writes each output, ``LIST_CAP``
    at a time; a base patch that nothing selects is not computed, and an
    output that no scan reaches stays NaN."""
    if kind == "K4":
        grads, amp, phase = _group_planes(patches, rows, (0,))
        return torch.stack([grads[0], amp, phase], dim=-1)
    if kind == "K2":
        grads, amp, phase = _group_planes(patches, rows, (0, 1, 2))
        return torch.stack([grads[v] for v in range(3)]), amp, phase
    m, h, w = patches.shape
    outs = tuple(torch.full((base_idx.shape[0], h, w), float("nan"), device=patches.device)
                 for _ in range(3))
    for b in range(m):
        js = torch.nonzero(base_idx == b).flatten().tolist()
        if not js:
            continue
        vs = [int(pidx[j]) for j in js]
        grads, amp, phase = _group_planes(patches[b:b + 1], rows, sorted(set(vs)))
        for first in range(0, len(js), LIST_CAP):
            for j, v in zip(js[first:first + LIST_CAP], vs[first:first + LIST_CAP]):
                outs[0][j], outs[1][j], outs[2][j] = grads[v][0], amp[0], phase[0]
    return outs


class IndexTrap(Exception):
    """A bad index, where the K3 kernel traps."""


def _swizzled(row, col):
    """K3's float offset of (row, col) in a square (``swizzled``): 128-byte
    rows, the 16-byte chunk c of row r at c ^ (r % 8)."""
    return row * GATHER_SIDE + (((col >> 2) ^ (row & 7)) << 2) + (col & 3)


def _transpose4(a):
    """``transpose4`` over a warp's (32, 4) values: in round s lane l sends
    its element (l + s) % 4 and takes lane (l - s) % 4's into slot
    (l - s) % 4."""
    lane = np.arange(32)
    l, group = lane & 3, lane & ~3
    b = a.copy()
    for s in range(1, 4):
        sent = a[lane, (l + s) & 3]
        b[lane, (l - s) & 3] = sent[group | ((l - s) & 3)]
    return b


def _gather_lanes(sqs, v, r0, c0, nr, nc, h, w, stride, out0, write):
    """K3's 16-byte path for one output of a square: each warp's 4 output
    rows rho of 32 pixels, a lane's 4 pixels t of one (variants 0, 1 a
    chunk of square row 4 warp + rho; 2, 3 of row ``lane`` transposed by
    :func:`_transpose4`); stride 1 stores them, stride 3 interleaves the
    warp's rows in its staging rows and stores each row's 24 chunks."""
    lane = np.arange(32)
    flip = v in (1, 3)
    rows, n_px, lead, start = (nr, nc, r0, c0) if v < 2 else (nc, nr, c0, r0)
    for warp in range(GATHER_THREADS // 32):
        if v < 2:
            rho, t = lane >> 3, lane & 7
            vals = np.stack([sq[_swizzled(4 * warp + rho, 4 * t)[:, None] + np.arange(4)]
                             for sq in sqs])  # (3, 32 lanes, 4)
        else:
            rho, t = lane & 3, lane >> 2
            vals = np.stack([_transpose4(sq[_swizzled(lane, 4 * warp)[:, None] + np.arange(4)])
                             for sq in sqs])
        q_row = 4 * warp + np.arange(4)
        row_px = np.where(q_row < rows,
                          out0 + np.where(flip, h - 1 - lead - q_row, lead + q_row) * w + start,
                          -1)
        if stride == 1:
            ok = (row_px[rho] >= 0) & (4 * t < n_px)
            for j in range(4):
                write((row_px[rho] + 4 * t + j)[ok], vals[:, ok, j])
            continue
        staged = np.full((4, 96), np.nan, np.float32)
        for j in range(4):
            for c in range(3):
                staged[rho, 12 * t + 3 * j + c] = vals[c, :, j]
        staged = staged.reshape(-1)
        for j in range(3):
            f = 32 * j + lane
            rr, q = f // 24, f % 24
            ok = (row_px[rr] >= 0) & (4 * q < 3 * n_px)
            for e in range(4):  # float e of chunk q: pixel (4q + e) // 3, plane (4q + e) % 3
                at = 3 * row_px[rr][ok] + 4 * q[ok] + e
                out_flat = staged[4 * f[ok] + e]
                px, c = at // 3, at % 3
                write.raw(px, c, out_flat)


def plane_gather_model(planes, base_idx, pidx, variant, stride, grid=5, fast=None):
    """Torch model of K3 (csrc/plane_gather.cu) on the CPU: the units (base
    patch, 32 x 32 square), base-major, in ``grid`` contiguous ranges; a
    CTA's scan of ``base_idx`` for a patch's outputs (``LIST_CAP`` listed
    at a time, a ring of list slots), its squares loaded into a ring of
    ``GATHER_STAGES`` stages in the
    128-byte swizzle (TMA boxes where ``fast``, zeros past the rows'
    end; else per-thread loads), and every selecting output's square at
    its mirrored position. ``fast`` (default: w % 4 == 0) takes the 16-byte
    lanes: variants 0 and 1 a chunk of a row a lane, 2 and 3 a chunk of a
    row transposed by :func:`_transpose4`; else pixel by pixel.
    ``base_idx`` and ``pidx`` None: identity mode (grad (K, h, w), output
    i is patch i). Returns the output buffer, (3, K, h, w) for ``stride``
    1 and (K, h, w, 3) for 3, NaN where nothing was written; raises
    :class:`IndexTrap` where the kernel traps."""
    grad, amp, phase = (np.ascontiguousarray(x.numpy(), dtype=np.float32) for x in planes)
    variant = np.asarray(variant, dtype=np.int64)
    identity = base_idx is None
    if not identity:
        base_idx, pidx = np.asarray(base_idx, np.int64), np.asarray(pidx, np.int64)
    m, h, w = amp.shape
    k = len(variant)
    side = GATHER_SIDE
    fast = w % 4 == 0 if fast is None else fast
    rows_of = {"amp": amp.reshape(-1, w), "phase": phase.reshape(-1, w),
               "grad": grad.reshape(-1, w)}
    sq_cols = -(-w // side)
    squares = sq_cols * -(-h // side)
    units = m * squares
    out = np.full(3 * k * h * w, np.nan, np.float32)
    plane_step = 1 if stride == 3 else k * h * w
    rr, cc = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    offsets = _swizzled(rr, cc)

    def write(px, vals):  # vals (3, n): the three planes' values at pixels px
        for c in range(3):
            out[stride * px + c * plane_step] = vals[c]

    def raw(px, c, vals):  # plane c of pixels px
        out[stride * px + c * plane_step] = vals
    write.raw = raw

    def collect(b, first):
        if identity:
            v = int(variant[b])
            if not 0 <= v <= 3 or (v >= 2 and h != w):
                raise IndexTrap(f"variant {v}")
            return {"first": 0, "total": 1, "mask": 1, "list": [(b, 0, v)]}
        if ((base_idx < 0) | (base_idx >= m)).any():
            raise IndexTrap("base_idx")
        hits = np.flatnonzero(base_idx == b)
        for e in hits:
            pl, v = int(pidx[e]), int(variant[e])
            if not (0 <= pl <= 2 and 0 <= v <= 3) or (v >= 2 and h != w):
                raise IndexTrap(f"pidx {pl}, variant {v}")
        mask = 0
        for e in hits:
            mask |= 1 << int(pidx[e])
        return {"first": first, "total": len(hits), "mask": mask,
                "list": [(int(e), int(pidx[e]), int(variant[e]))
                         for e in hits[first:first + LIST_CAP]]}

    def where(u):
        b, sq = divmod(u, squares)
        return b, (sq // sq_cols) * side, (sq % sq_cols) * side

    def issue(u, slot, stage):
        b, r0, c0 = where(u)
        stage[:] = np.nan  # what the stage held before
        for s, (name, plane) in enumerate([("amp", 0), ("phase", 0), ("grad", 0),
                                           ("grad", 1), ("grad", 2)]):
            if s >= 2 and not slot["mask"] >> (s - 2) & 1:
                continue
            y = (plane * m + b) * h + r0
            if fast:  # a TMA box: the rows past the patch are the next patch's
                src = rows_of[name][y:y + side, c0:c0 + side]
            else:
                src = rows_of[name][y:y + min(side, h - r0), c0:c0 + side]
            box = np.zeros((side, side), np.float32)
            box[:src.shape[0], :src.shape[1]] = src
            stage[s, offsets] = box

    def store(u, slot, stage):
        b, r0, c0 = where(u)
        nr, nc = min(side, h - r0), min(side, w - c0)
        for first in range(0, slot["total"], LIST_CAP):
            if slot["first"] != first:
                slot.update(collect(b, first))
            for o, pl, v in slot["list"]:
                sqs = stage[[2 + pl, 0, 1]]  # grad, amp, phase
                out0 = o * h * w
                if fast:
                    _gather_lanes(sqs, v, r0, c0, nr, nc, h, w, stride, out0, write)
                else:
                    e = np.arange(nr * nc)
                    if v < 2:
                        row, col = e // nc, e % nc
                        r = r0 + row if v == 0 else h - 1 - r0 - row
                        px = r * w + c0 + col
                    else:
                        col, row = e // nr, e % nr
                        r = c0 + col if v == 2 else h - 1 - c0 - col
                        px = r * w + r0 + row
                    write(out0 + px, sqs[:, _swizzled(row, col)])

    for cta in range(min(grid, units)):
        u_begin = units * cta // min(grid, units)
        u_end = units * (cta + 1) // min(grid, units)
        n_lists = GATHER_STAGES + 1
        slots = [None] * n_lists
        stages = np.full((GATHER_STAGES, 5, side * side), np.nan, np.float32)
        queued = {}  # stage -> (unit, list slot)

        def find(u, s):
            while u < u_end:
                b = u // squares
                slots[s] = collect(b, 0)
                if slots[s]["total"]:
                    return u
                u = (b + 1) * squares
            return u_end
        state = {"next": find(u_begin, 0), "ordinal": 0, "issued": 0}

        def queue():
            st, s = state["issued"] % GATHER_STAGES, state["ordinal"] % n_lists
            queued[st] = (state["next"], s)
            issue(state["next"], slots[s], stages[st])
            state["issued"] += 1
            after = state["next"] + 1
            if after < u_end and after // squares != state["next"] // squares:
                state["ordinal"] += 1
                state["next"] = find(after, state["ordinal"] % n_lists)
            else:
                state["next"] = after
        while state["issued"] < GATHER_STAGES - 1 and state["next"] < u_end:
            queue()
        done = 0
        while done < state["issued"]:
            if state["next"] < u_end:
                queue()
            st = done % GATHER_STAGES
            u, s = queued[st]
            store(u, slots[s], stages[st])
            done += 1
    shape = (3, k, h, w) if stride == 1 else (k, h, w, 3)
    return torch.from_numpy(out.reshape(shape))
