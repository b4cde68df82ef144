"""Port parity: torch models of the passes of K2, K1 and K4 on the card
(``fused_extract_channel_planes_model``, ``fused_gather_extract_model`` and
``fused_extract_channels_model`` in ``tests/torch_kernel_models.py``: each
patch's rows split across a cluster of 4 CTAs with halo rows from the neighbours, each plane's
min and max reduced across the 4 parts, divisions folded into reciprocals
and FMAs, K1's outputs found per base patch by a scan of ``base_idx``, K4's
channels interleaved as (N, H, W, 3)) against the plain versions and the
JAX package, on the CPU; and the float32 square root that ``magnitude``
takes on the card. Above 128 x 128: models of the strip kernel's two passes,
of the resident-group kernel's slabs (``fused_extract_groups_model``: K4, K2
and K1 fused, held also bit-equal to the strip model), and the shape-only
routing (``extract_route``) between them. K3 (``plane_gather_model``): its
squares, scan, lists, swizzle, lanes and pixel stride, bit-equal to the plain
version in both layouts and in identity mode.

The JAX kernels run in Pallas interpret mode, as tests/test_ops.py runs
them, on complex input without NaN (they take no min over NaN and treat
real input as complex); real input and NaN pixels are held to the JAX
reference pipeline (``preprocess/pipeline.py``). Tolerance: 2e-5, the JAX
package's own extraction bound (``ops/fused_channels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.ops import fused_channels as JK
from rfi_toolbox_tpu.preprocess import pipeline as JP
from rfi_toolbox_tpu_torch.ops import fused_channels as F
from rfi_toolbox_tpu_torch.preprocess import pipeline as P
from rfi_toolbox_tpu_torch.preprocess import static_prep as S

import torch_kernel_models as M

TOL = 2e-5


def _complex(rng, n, h, w):
    amp = rng.lognormal(0.0, 1.5, (n, h, w))
    phase = rng.uniform(0, 2 * np.pi, (n, h, w))
    return (amp * np.exp(1j * phase)).astype(np.complex64)


def _with_nan(rng, n, h, w):
    x = _complex(rng, n, h, w)
    x.reshape(-1)[rng.random(x.size) < 0.05] = np.nan
    x[-1] = np.nan  # a patch of no valid pixel
    return x


# name -> (patches, the JAX function held beside the plain version: "kernel"
# (Pallas, interpret mode), "pipeline" (the reference) or None). On the CPU
# the JAX package's log-amplitude of a constant patch varies by an ulp
# between pixels, and its min-max gradient planes then hold 0 and 1: the
# constant patch is held to the plain version alone.
CASES = {
    "16x16": (lambda rng: _complex(rng, 6, 16, 16), "kernel"),
    "constant": (lambda rng: np.full((3, 16, 16), 2 + 1j, np.complex64), None),
    "real f32": (lambda rng: rng.normal(size=(4, 16, 16)).astype(np.float32), "pipeline"),
    "NaN pixels": (lambda rng: _with_nan(rng, 4, 16, 16), "pipeline"),
    "3x5": (lambda rng: _complex(rng, 5, 3, 5), "kernel"),
    "5x7": (lambda rng: _complex(rng, 5, 5, 7), "kernel"),
    "33x128": (lambda rng: _complex(rng, 3, 33, 128), "kernel"),
    "128x128": (lambda rng: _complex(rng, 2, 128, 128), "kernel"),
    "128x127": (lambda rng: _complex(rng, 2, 128, 127), "kernel"),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


def _jax_planes(x, reference):
    if reference == "kernel":
        return JK.fused_extract_channel_planes(jnp.asarray(x), interpret=True)
    return JP.extract_channel_planes(jnp.asarray(x))


@pytest.mark.parametrize("case", list(CASES))
def test_channel_planes_model(case):
    make, reference = CASES[case]
    x = make(np.random.default_rng(10))
    got = M.fused_extract_channel_planes_model(_t(x))
    plain = F.fused_extract_channel_planes_plain(_t(x))
    assert [tuple(g.shape) for g in got] == [tuple(p.shape) for p in plain]
    for g, p in zip(got, plain):
        _close(g, p)
    if reference:
        for g, j in zip(got, _jax_planes(x, reference)):
            _close(g, j)


@pytest.mark.parametrize("case", list(CASES))
def test_channels_model(case):
    """K4's model against its plain version, and against the Pallas K4
    (interpret mode) on complex input or the JAX reference pipeline on
    real input and NaN pixels (``CASES``)."""
    make, reference = CASES[case]
    x = make(np.random.default_rng(14))
    got = M.fused_extract_channels_model(_t(x))
    plain = F.fused_extract_channels_plain(_t(x))
    assert got.shape == plain.shape == (*x.shape, 3)
    _close(got, plain)
    if reference == "kernel":
        _close(got, JK.fused_extract_channels(jnp.asarray(x), interpret=True))
    elif reference == "pipeline":
        _close(got, JP.imagenet_normalize(JP.extract_channels(jnp.asarray(x))))


def _indices(rng, pattern, m):
    """(base_idx, pidx) int32 of one index pattern over m base patches."""
    if pattern == "odd K":  # K = 17, repeats
        return rng.integers(0, m, 17), rng.integers(0, 3, 17)
    if pattern == "repeated pairs":  # the same (base, pidx) again and again
        base, plane = np.array([1, 1, 1, 0, 1, 0, 1]), np.array([2, 2, 2, 0, 2, 1, 2])
        return base, plane
    if pattern == "unselected bases":  # bases 1 and m-1 never selected
        return np.array([0, 2, 0, 2, 2]) % m, np.array([0, 1, 2, 0, 0])
    if pattern == "one base, 2 lists":  # more outputs of a base than a list holds
        n = M.LIST_CAP + 9
        base = np.concatenate([np.zeros(n, int), [m - 1, 0]])
        order = rng.permutation(base.size)
        return base[order], rng.integers(0, 3, base.size)
    raise ValueError(pattern)


@pytest.mark.parametrize("pattern", ["odd K", "repeated pairs", "unselected bases",
                                     "one base, 2 lists"])
@pytest.mark.parametrize("case", ["16x16", "constant", "real f32", "NaN pixels", "5x7"])
def test_gather_extract_model(case, pattern):
    make, reference = CASES[case]
    rng = np.random.default_rng(11)
    x = make(rng)
    base_idx, pidx = (a.astype(np.int32) for a in _indices(rng, pattern, x.shape[0]))
    got = M.fused_gather_extract_model(_t(x), _t(base_idx), _t(pidx))
    plain = F.fused_gather_extract_plain(_t(x), _t(base_idx), _t(pidx))
    for g, p in zip(got, plain):
        assert g.shape == (base_idx.size, *x.shape[1:])
        _close(g, p)
    if reference == "kernel":
        ref = JK.fused_gather_extract(jnp.asarray(x), jnp.asarray(base_idx),
                                      jnp.asarray(pidx), interpret=True)
    elif reference == "pipeline":
        grad3, amp, phase = (np.asarray(a) for a in JP.extract_channel_planes(jnp.asarray(x)))
        ref = (grad3[pidx, base_idx], amp[base_idx], phase[base_idx])
    for g, r in zip(got, ref if reference else ()):
        _close(g, r)


def test_gather_extract_model_on_the_static_selection():
    """K1's real pattern: K = 30 of the 32 virtual patches of 8 base
    patches (4 variants), so each base is selected at most 4 times and
    orig and T share gradient plane 0."""
    rng = np.random.default_rng(12)
    x = _complex(rng, 8, 32, 32)
    virtual = rng.permutation(32)[:30]
    base_idx = (virtual % 8).astype(np.int32)
    pidx = np.array([0, 1, 0, 2], np.int32)[virtual // 8]
    got = M.fused_gather_extract_model(_t(x), _t(base_idx), _t(pidx))
    want = JK.fused_gather_extract(jnp.asarray(x), jnp.asarray(base_idx),
                                   jnp.asarray(pidx), interpret=True)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("h, parts", [
    (1, [(0, 1), (1, 1), (1, 1), (1, 1)]),
    (3, [(0, 1), (1, 2), (2, 3), (3, 3)]),
    (5, [(0, 2), (2, 4), (4, 5), (5, 5)]),
    (33, [(0, 9), (9, 18), (18, 27), (27, 33)]),
    (128, [(0, 32), (32, 64), (64, 96), (96, 128)]),
])
def test_row_parts(h, parts):
    """Each CTA of a cluster owns ceil(h / 4) rows; the rows tile [0, h)."""
    assert M._row_parts(h) == parts


def test_float32_sqrt_equals_float64_sqrt_rounded_on_1_2():
    """Every float32 s in [1, 2] (the range of fma(r, r, 1) in
    ``magnitude``): the float32 square root the kernels take equals the
    float64 square root rounded to float32 that the plain version takes."""
    s = np.arange(0x3F800000, 0x40000001, dtype=np.uint32).view(np.float32)
    single = np.sqrt(s)
    double = np.sqrt(s.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(single.view(np.uint32), double.view(np.uint32))


def test_magnitude_with_float32_root_bit_equal():
    """``magnitude`` with the float32 root, as the kernels compute it, is
    bit-equal to the plain version's on random and edge values."""
    rng = np.random.default_rng(13)
    parts = np.concatenate([
        rng.lognormal(0.0, 8.0, 20000), rng.normal(size=20000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 3.4e38, 1e-30, 1.0]]).astype(np.float32)
    re = rng.permutation(parts)
    im = rng.permutation(parts)
    a, b = np.abs(re), np.abs(im)
    larger, smaller = np.maximum(a, b), np.minimum(a, b)
    ok = (larger != 0) & (smaller != np.inf)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.where(ok, smaller / np.where(ok, larger, 1), 0).astype(np.float32)
    s = (ratio.astype(np.float64) ** 2 + 1.0).astype(np.float32)
    with np.errstate(invalid="ignore"):
        kernel = np.sqrt(s) * larger
    plain = P.magnitude(torch.complex(_t(re), _t(im))).numpy()
    nan = np.isnan(plain)
    np.testing.assert_array_equal(np.isnan(kernel), nan)
    np.testing.assert_array_equal(kernel[~nan].view(np.uint32), plain[~nan].view(np.uint32))


# Patches above 128 x 128 (the strip kernel, csrc/extract_strips.cu).
LARGE = {
    "129x130": (lambda rng: _complex(rng, 2, 129, 130), "pipeline"),
    "256x256": (lambda rng: _complex(rng, 2, 256, 256), "kernel"),
    "1000x1024": (lambda rng: _complex(rng, 1, 1000, 1024), "pipeline"),
    "33x1024 real": (lambda rng: rng.lognormal(0, 1, (2, 33, 1024)).astype(np.float32),
                     "pipeline"),
    "NaN 150x140": (lambda rng: _with_nan(rng, 3, 150, 140), "pipeline"),
    "constant 144x144": (lambda rng: np.full((2, 144, 144), 2 + 1j, np.complex64), None),
}


@pytest.mark.parametrize("case", list(LARGE))
def test_strips_model_channels(case):
    """K4's strip model against its plain version, and against the Pallas
    K4 (interpret mode, 256 x 256) or the JAX reference pipeline."""
    make, reference = LARGE[case]
    x = make(np.random.default_rng(15))
    got = M.fused_extract_strips_model(_t(x), "K4")
    plain = F.fused_extract_channels_plain(_t(x))
    assert got.shape == plain.shape == (*x.shape, 3)
    _close(got, plain)
    if reference == "kernel":
        _close(got, JK.fused_extract_channels(jnp.asarray(x), interpret=True))
    if reference:
        _close(plain, JP.imagenet_normalize(JP.extract_channels(jnp.asarray(x))))


@pytest.mark.parametrize("case", list(LARGE))
def test_strips_model_planes(case):
    make, reference = LARGE[case]
    x = make(np.random.default_rng(16))
    got = M.fused_extract_strips_model(_t(x), "K2")
    plain = F.fused_extract_channel_planes_plain(_t(x))
    assert [tuple(g.shape) for g in got] == [tuple(p.shape) for p in plain]
    for g, p in zip(got, plain):
        _close(g, p)
    if reference:
        for p, j in zip(plain, JP.extract_channel_planes(jnp.asarray(x))):
            _close(p, j)


@pytest.mark.parametrize("n, side", [(2, 256), (1, 1024)])
def test_plain_extraction_matches_jax_at_large_patches(n, side):
    """The plain versions the strip kernel is held to, against the JAX
    pipeline at 256 x 256 and 1024 x 1024, and against the Pallas K4 and
    K2 (interpret mode) at 256 x 256."""
    x = _complex(np.random.default_rng(17), n, side, side)
    x[:, side // 3: side // 3 + 4] *= 1e4  # a bright stripe
    plain = F.fused_extract_channels_plain(_t(x))
    _close(plain, JP.imagenet_normalize(JP.extract_channels(jnp.asarray(x))))
    planes = F.fused_extract_channel_planes_plain(_t(x))
    for p, j in zip(planes, JP.extract_channel_planes(jnp.asarray(x))):
        _close(p, j)
    if side == 256:
        _close(plain, JK.fused_extract_channels(jnp.asarray(x), interpret=True))
        for p, j in zip(planes, JK.fused_extract_channel_planes(jnp.asarray(x),
                                                                 interpret=True)):
            _close(p, j)


def test_order_keys_preserve_order():
    """The strip kernel's integer keys order float32 values as floats do
    (-inf < negatives < -0.0 < +0.0 < positives < +inf) and map back."""
    v = np.array([-np.inf, -3e38, -1.5, -1e-40, -0.0, 0.0, 1e-40, 2.0, 3e38, np.inf],
                 np.float32)
    keys = M._order_key(_t(v))
    assert bool((keys[1:] > keys[:-1]).all())
    back = M._key_value(keys).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), v.view(np.uint32))


# K3 (csrc/plane_gather.cu): (h, w) -> whether the 16-byte path takes it
# (w % 4 == 0) and its squares' ragged edge. Rectangular tiles take
# variants 0 and 1 only (K1's strip route gathers with variant 0).
K3_SHAPES = {"16x16": (16, 16), "33x33": (33, 33), "36x36": (36, 36), "69x69": (69, 69),
             "100x100": (100, 100), "129x129": (129, 129), "160x160": (160, 160),
             "129x140": (129, 140), "40x200": (40, 200)}


def _k3_want(planes, base_idx, pidx, variant, stride):
    """The plain K3 in the layout of ``stride``; on rectangular tiles the
    row flip of the gathered planes."""
    if planes[1].shape[1] == planes[1].shape[2]:
        got = F.fused_plane_gather_transform_plain(planes, base_idx, pidx, variant)
    else:
        flip = (variant == 1)[:, None, None]
        got = tuple(torch.where(flip, g.flip(-2), g)
                    for g in F._gather_planes(planes, base_idx, pidx))
    return torch.stack(got, 0 if stride == 1 else -1)


def _bit_equal(got, want):
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("stride", [1, 3], ids=["planes", "images"])
@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_plane_gather_model(shape, stride):
    """K3's model, bit-equal to the plain version: all four variants on
    square tiles (ragged last squares, the 16-byte and the per-pixel
    path), variants 0 and 1 on rectangular ones; NaN pixels kept."""
    h, w = K3_SHAPES[shape]
    rng = np.random.default_rng(18)
    planes = F.fused_extract_channel_planes_plain(_t(_with_nan(rng, 3, h, w)))
    k = 11
    base_idx = _t(rng.integers(0, 3, k))
    pidx = _t(rng.integers(0, 3, k))
    variant = _t(rng.integers(0, 4 if h == w else 2, k))
    variant[:4 if h == w else 2] = torch.arange(4 if h == w else 2)
    got = M.plane_gather_model(planes, base_idx, pidx, variant, stride)
    _bit_equal(got, _k3_want(planes, base_idx, pidx, variant, stride))


@pytest.mark.parametrize("stride", [1, 3], ids=["planes", "images"])
@pytest.mark.parametrize("case", ["repeats, unselected", "K=1, M=1", "one base 150 times",
                                  "a unit a CTA"])
def test_plane_gather_model_index_patterns(case, stride):
    """K3's model on the indices' patterns: repeated (base, plane) pairs
    with base patches nothing selects and pidx independent of the variant,
    one output of one base patch, a patch selected 150 times (three lists
    of ``LIST_CAP``, listed again for each square), and as many CTAs as
    units (ranges that start inside a patch)."""
    rng = np.random.default_rng(19)
    m, side, grid = 6, 36, 5
    if case == "repeats, unselected":
        base_idx, pidx = [4, 4, 1, 4, 1, 4, 4], [2, 2, 0, 2, 1, 0, 2]
        variant = [3, 3, 0, 1, 2, 2, 0]
    elif case == "K=1, M=1":
        m, base_idx, pidx, variant = 1, [0], [1], [3]
    elif case == "one base 150 times":
        base_idx = rng.permutation([2] * 150 + [0, 5])
        pidx, variant = rng.integers(0, 3, 152), rng.integers(0, 4, 152)
    else:
        side, grid = 69, 10**6
        base_idx, pidx, variant = rng.integers(0, m, 9), rng.integers(0, 3, 9), np.arange(9) % 4
    planes = F.fused_extract_channel_planes_plain(_t(_complex(rng, m, side, side)))
    idx = [_t(np.asarray(x, np.int64)) for x in (base_idx, pidx, variant)]
    got = M.plane_gather_model(planes, *idx, stride, grid=grid)
    _bit_equal(got, _k3_want(planes, *idx, stride))


@pytest.mark.parametrize("stride", [1, 3], ids=["planes", "images"])
@pytest.mark.parametrize("side", [16, 33, 100])
def test_plane_gather_model_identity(side, stride):
    """K3's identity mode on K1's planes (output i is patch i in its
    variant), bit-equal to the stack and transform it replaces on the
    'auto' route; the images wrapper's plain version the same on the
    CPU."""
    rng = np.random.default_rng(20)
    x = _t(_complex(rng, 4, side, side))
    k = 13
    base_idx, pidx = _t(rng.integers(0, 4, k)), _t(rng.integers(0, 3, k))
    variant = _t(np.arange(k) % 4)
    planes = F.fused_gather_extract_plain(x, base_idx, pidx)
    got = M.plane_gather_model(planes, None, None, variant, stride)
    want = S.transform_by_variant_nhwc(torch.stack(planes, -1), variant)
    if stride == 1:
        want = want.permute(3, 0, 1, 2)
    _bit_equal(got, want.contiguous())
    _bit_equal(F.fused_plane_gather_transform_images(planes, None, None, variant),
               S.transform_by_variant_nhwc(torch.stack(planes, -1), variant))


@pytest.mark.parametrize("bad", ["base_idx", "pidx", "variant", "transpose of 36x40"])
def test_plane_gather_model_traps_on_bad_indices(bad):
    """Where the kernel traps: a base_idx, pidx or variant out of range, a
    transposing variant on a rectangular tile."""
    rng = np.random.default_rng(21)
    h, w = (36, 40) if bad.startswith("transpose") else (36, 36)
    planes = F.fused_extract_channel_planes_plain(_t(_complex(rng, 3, h, w)))
    idx = {"base_idx": [0, 2, 1], "pidx": [0, 1, 2], "variant": [0, 1, 1]}
    if bad in idx:
        idx[bad][1] = {"base_idx": 3, "pidx": -1, "variant": 4}[bad]
    else:
        idx["variant"][2] = 2
    with pytest.raises(M.IndexTrap):
        M.plane_gather_model(planes, *(_t(np.asarray(x)) for x in idx.values()), 3)


# Patches above 128 x 128 on the resident-group kernel (csrc/extract_groups.cu):
# name -> (patches, rows a slab, the JAX function held beside the plain
# version, as in CASES). 129x130 and 256x256 at the rows ``extract_route``
# gives them on an H100 (15, 16); 1000x1024 at 11 rows, which do not divide
# it (1000 = 90 x 11 + 10).
GROUPS = {
    "129x130": (lambda rng: _complex(rng, 2, 129, 130), 15, "pipeline"),
    "256x256": (lambda rng: _complex(rng, 2, 256, 256), 16, "kernel"),
    "1000x1024 R=11": (lambda rng: _complex(rng, 1, 1000, 1024), 11, "pipeline"),
    "G=1 150x140": (lambda rng: _complex(rng, 2, 150, 140), 150, "pipeline"),
    "G=256 256x256": (lambda rng: _complex(rng, 2, 256, 256), 1, "kernel"),
    "NaN 150x140": (lambda rng: _with_nan(rng, 3, 150, 140), 16, "pipeline"),
    "constant 144x144": (lambda rng: np.full((2, 144, 144), 2 + 1j, np.complex64), 16, None),
    "real 33x1024": (lambda rng: rng.lognormal(0, 1, (2, 33, 1024)).astype(np.float32), 11,
                     "pipeline"),
    "real 130x131": (lambda rng: rng.normal(size=(2, 130, 131)).astype(np.float32), 9,
                     "pipeline"),
}


def _nan_equal(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case", list(GROUPS))
def test_groups_model_channels(case):
    """K4's resident-group model against its plain version and the Pallas
    K4 (interpret mode) or the JAX reference pipeline, and bit-equal to the
    strip kernel's model on the same input."""
    make, rows, reference = GROUPS[case]
    x = make(np.random.default_rng(19))
    got = M.fused_extract_groups_model(_t(x), "K4", rows)
    plain = F.fused_extract_channels_plain(_t(x))
    assert got.shape == plain.shape == (*x.shape, 3)
    _close(got, plain)
    _nan_equal(got, M.fused_extract_strips_model(_t(x), "K4"))
    if reference == "kernel":
        _close(got, JK.fused_extract_channels(jnp.asarray(x), interpret=True))
    elif reference == "pipeline":
        _close(got, JP.imagenet_normalize(JP.extract_channels(jnp.asarray(x))))


@pytest.mark.parametrize("case", list(GROUPS))
def test_groups_model_planes(case):
    make, rows, reference = GROUPS[case]
    x = make(np.random.default_rng(20))
    got = M.fused_extract_groups_model(_t(x), "K2", rows)
    plain = F.fused_extract_channel_planes_plain(_t(x))
    assert [tuple(g.shape) for g in got] == [tuple(p.shape) for p in plain]
    for g, p, s in zip(got, plain, M.fused_extract_strips_model(_t(x), "K2")):
        _close(g, p)
        _nan_equal(g, s)
    if reference:
        for g, j in zip(got, _jax_planes(x, reference)):
            _close(g, j)


@pytest.mark.parametrize("pattern", ["odd K", "repeated pairs", "unselected bases",
                                     "one base, 2 lists"])
@pytest.mark.parametrize("case", ["129x130", "256x256", "NaN 150x140", "constant 144x144",
                                  "real 130x131"])
def test_groups_model_gather(case, pattern):
    """K1 fused on the resident-group kernel, against its plain version
    (the planes of every base patch, then the gather) and the Pallas K1
    (interpret mode) or the JAX pipeline's planes gathered: repeated base
    patches and (base, plane) pairs, base patches that nothing selects, and
    one base patch with more outputs than a list holds (there the JAX
    pipeline: the Pallas interpreter takes a grid step an output, 75 of
    them)."""
    make, rows, reference = GROUPS[case]
    rng = np.random.default_rng(21)
    x = make(rng)
    base_idx, pidx = (a.astype(np.int32) for a in _indices(rng, pattern, x.shape[0]))
    if reference == "kernel" and pattern == "one base, 2 lists":
        reference = "pipeline"
    got = M.fused_extract_groups_model(_t(x), "K1", rows, _t(base_idx), _t(pidx))
    plain = F.fused_gather_extract_plain(_t(x), _t(base_idx), _t(pidx))
    for g, p in zip(got, plain):
        assert g.shape == (base_idx.size, *x.shape[1:])
        _close(g, p)
    if reference == "kernel":
        ref = JK.fused_gather_extract(jnp.asarray(x), jnp.asarray(base_idx),
                                      jnp.asarray(pidx), interpret=True)
    elif reference == "pipeline":
        grad3, amp, phase = (np.asarray(a) for a in JP.extract_channel_planes(jnp.asarray(x)))
        ref = (grad3[pidx, base_idx], amp[base_idx], phase[base_idx])
    for g, r in zip(got, ref if reference else ()):
        _close(g, r)


H100_RESIDENT = 4 * 132  # the resident-group kernel's CTAs on an H100: 4 an SM


@pytest.mark.parametrize("kind, shape, is_complex, route", [
    ("K4", (128, 128), True, ("cluster", 0)),
    ("K1", (128, 127), False, ("cluster", 0)),
    ("K4", (129, 130), True, ("groups", 15)),
    ("K4", (256, 256), True, ("groups", 16)),
    ("K2", (256, 256), True, ("groups", 16)),
    ("K1", (256, 256), True, ("groups", 16)),
    ("K4", (13200, 256), True, ("groups", 25)),
    ("K4", (13201, 256), True, ("strips", 0)),
    ("K4", (160, 691), True, ("groups", 8)),
    ("K4", (160, 692), True, ("strips", 0)),
    ("K4", (1024, 1024), True, ("strips", 0)),
    ("K4", (1000, 1024), True, ("strips", 0)),
    ("K2", (1024, 1024), True, ("groups", 4)),
    ("K1", (1000, 1024), True, ("groups", 4)),
    ("K2", (2048, 2048), True, ("strips", 0)),
    ("K1", (2048, 2048), True, ("strips", 0)),
    ("K4", (2048, 2048), True, ("strips", 0)),
    ("K4", (1024, 1024), False, ("groups", 11)),
    ("K4", (2048, 1382), False, ("groups", 8)),
    ("K4", (2048, 1384), False, ("strips", 0)),
    ("K2", (2048, 1384), False, ("groups", 7)),
])
def test_extract_route(kind, shape, is_complex, route):
    """The kernel by shape on an H100: the cluster kernel up to 128 x 128
    pixels; the resident-group kernel while a patch's slabs fit the
    resident CTAs with the kind's fewest rows a slab (K4 8, K2 and K1 1;
    16 rows where they fit, more where 16 would make too many slabs,
    evened out); else the strip kernel."""
    code = {"K4": F._K4, "K2": F._K2, "K1": F._K1}[kind]
    assert F.extract_route(code, *shape, is_complex, H100_RESIDENT) == route


def test_extract_route_never_overfills_the_grid():
    """No shape whose slabs outnumber the resident CTAs, or whose slab with
    its halo rows exceeds the shared memory budget, reaches the
    resident-group kernel; a shape refused has no slab height that fits
    with at least the kind's ``GROUP_MIN_ROWS`` rows."""
    rng = np.random.default_rng(22)
    for _ in range(4000):
        h, w = (int(v) for v in rng.integers(1, 4096, 2))
        is_complex = bool(rng.integers(0, 2))
        resident = int(rng.choice([1, 7, 132, 264, 528]))
        kind = int(rng.choice([F._K4, F._K2, F._K1]))
        route, rows = F.extract_route(kind, h, w, is_complex, resident)
        row_bytes = w * (8 if is_complex else 4)
        fits = [r for r in range(1, h + 1)
                if -(-h // r) <= resident and (r + 2) * row_bytes <= F.GROUP_SMEM_BYTES]
        if h * w <= F.CLUSTER_MAX_PIXELS:
            assert route == "cluster"
        elif route == "groups":
            assert rows in fits and -(-h // rows) <= -(-h // F.GROUP_MIN_ROWS[kind])
            assert rows * (-(-h // rows) - 1) < h  # no empty slab
        else:
            assert route == "strips"
            assert not [r for r in fits if r >= F.GROUP_MIN_ROWS[kind]]
