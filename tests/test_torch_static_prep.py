"""Port parity: the static virtual-augmentation preprocess, its kernels'
plain versions (K1, K2, K3), the rest of the pipeline and
``Preprocessor.create_dataset`` against the JAX package, on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_ops.py runs
them; the JAX static path runs its jnp reference (``use_pallas=False``).
The port runs with ``use_kernels`` both on and off: on CPU tensors both
take the plain versions.

The shuffle of the static selection is ``jax.random.permutation`` in the
reference and ``torch.randperm`` in the port, which cannot be matched.
So the deterministic ``kept`` indices are compared bit for bit, the JAX
``keep`` is fed to the port's :meth:`StaticPrep.from_keep`, and
whole-path outputs are compared row by row in the order of ``keep``.

Tolerances: images 2e-5 (the JAX package's own extraction bound,
``ops/fused_channels.py``); labels, K3's output (planes and images) and the
selections bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.ops import fused_channels as JK
from rfi_toolbox_tpu.preprocess import Preprocessor as JaxPreprocessor
from rfi_toolbox_tpu.preprocess import pipeline as JP
from rfi_toolbox_tpu.preprocess import preprocessor as JPP
from rfi_toolbox_tpu.preprocess import static_prep as JS
from rfi_toolbox_tpu_torch import ops
from rfi_toolbox_tpu_torch.preprocess import Preprocessor
from rfi_toolbox_tpu_torch.preprocess import pipeline as P
from rfi_toolbox_tpu_torch.preprocess import static_prep as S

TOL = 2e-5
PATCH = 16


def _waterfalls(rng, m=2, h=64, w=64, complex_=True):
    """Noise of |x| ~ 1 with channel stripes and time bursts of 30-50,
    their exact mask, random phase; one patch row left clean."""
    amp = rng.normal(1.0, 0.1, (m, h, w))
    mask = np.zeros((m, h, w), bool)
    for i in range(m):
        c = rng.integers(4, w - 4)
        amp[i, :, c:c + 2] += 50.0
        mask[i, :, c:c + 2] = True
        t = rng.integers(PATCH + 2, h - 4)
        amp[i, t:t + 3, :PATCH * 2] += 30.0
        mask[i, t:t + 3, :PATCH * 2] = True
    if not complex_:
        return amp.astype(np.float32), mask
    phase = rng.uniform(0, 2 * np.pi, (m, h, w))
    return (amp * np.exp(1j * phase)).astype(np.complex64), mask


def _patches(rng, n=6, h=PATCH, w=PATCH):
    amp = rng.lognormal(0.0, 1.5, (n, h, w))
    phase = rng.uniform(0, 2 * np.pi, (n, h, w))
    return (amp * np.exp(1j * phase)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


# -- K2 / K1 / K3 plain versions against the JAX kernels ----------------------

@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
def test_channel_planes_match_jax_kernel(plain):
    x = _patches(np.random.default_rng(0))
    fn = ops.fused_extract_channel_planes_plain if plain else ops.fused_extract_channel_planes
    got = fn(_t(x))
    kernel = JK.fused_extract_channel_planes(jnp.asarray(x), interpret=True)
    reference = JP.extract_channel_planes(jnp.asarray(x))
    assert got[0].shape == (3, 6, PATCH, PATCH)
    for g, k, r in zip(got, kernel, reference):
        _close(g, k)
        _close(g, r)


def test_channel_planes_real_input_match_jax():
    x = np.random.default_rng(1).normal(size=(3, PATCH, PATCH)).astype(np.float32)
    for g, r in zip(P.extract_channel_planes(_t(x)),
                    JP.extract_channel_planes(jnp.asarray(x))):
        _close(g, r)


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
def test_gather_extract_matches_jax_kernel(plain):
    rng = np.random.default_rng(2)
    x = _patches(rng, n=5)
    k = 17  # odd, with repeats
    base_idx = rng.integers(0, 5, size=k).astype(np.int32)
    pidx = rng.integers(0, 3, size=k).astype(np.int32)
    fn = ops.fused_gather_extract_plain if plain else ops.fused_gather_extract
    launches = ops.fused_gather_extract.launches
    got = fn(_t(x), _t(base_idx), _t(pidx))
    want = JK.fused_gather_extract(jnp.asarray(x), jnp.asarray(base_idx),
                                   jnp.asarray(pidx), interpret=True)
    for g, w in zip(got, want):
        assert g.shape == (k, PATCH, PATCH)
        _close(g, w)
    assert ops.fused_gather_extract.launches == launches  # CPU: no kernel


@pytest.mark.parametrize("plain", [True, False, "images"], ids=["plain", "wrapper", "images"])
def test_plane_gather_transform_bit_equal_to_jax_kernel(plain):
    """K3's plain version and wrapper, and the images wrapper's plain
    version against JAX's planes stacked to NHWC."""
    rng = np.random.default_rng(3)
    x = _patches(rng, n=5)
    k = 19
    base_idx = rng.integers(0, 5, size=k).astype(np.int32)
    v = rng.integers(0, 4, size=k).astype(np.int32)
    v[:4] = [0, 1, 2, 3]
    pidx = JS._VARIANT_GRAD_PLANE[v]
    planes = [np.asarray(a) for a in JP.extract_channel_planes(jnp.asarray(x))]
    fn = {True: ops.fused_plane_gather_transform_plain,
          False: ops.fused_plane_gather_transform,
          "images": ops.fused_plane_gather_transform_images_plain}[plain]
    got = fn(tuple(_t(a) for a in planes), _t(base_idx), _t(pidx), _t(v))
    want = JK.fused_plane_gather_transform(
        tuple(jnp.asarray(a) for a in planes), jnp.asarray(base_idx),
        jnp.asarray(pidx), jnp.asarray(v), interpret=True)
    if plain == "images":
        got, want = (got,), (np.stack([np.asarray(w) for w in want], -1),)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_transforms_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 5, 5)).astype(np.float32)
    v = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    np.testing.assert_array_equal(
        S.transform_by_variant(_t(x), _t(v).long()).numpy(),
        np.asarray(JS._transform_by_variant(jnp.asarray(x), jnp.asarray(v))))
    y = rng.normal(size=(8, 5, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        S.transform_by_variant_nhwc(_t(y), _t(v).long()).numpy(),
        np.asarray(JS._transform_by_variant_nhwc(jnp.asarray(y), jnp.asarray(v))))
    np.testing.assert_array_equal(S.VARIANT_GRAD_PLANE, JS._VARIANT_GRAD_PLANE)


@pytest.mark.parametrize("nh, nw, r", [(4, 4, 4), (2, 3, 4), (3, 2, 2), (2, 2, 1)])
def test_variant_remap_matches_jax(nh, nw, r):
    np.testing.assert_array_equal(S.variant_remap(nh, nw, r),
                                  JS.variant_remap(nh, nw, r))


# -- the rest of the pipeline ------------------------------------------------

@pytest.mark.parametrize("r", [1, 2, 4])
def test_apply_rotations_matches_jax(r):
    x = np.random.default_rng(5).normal(size=(2, 6, 4)).astype(np.float32)
    got = P.apply_rotations(_t(x), r)
    want = JP.apply_rotations(jnp.asarray(x), r)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _stretch_input(rng):
    x = rng.lognormal(0.0, 1.0, (4, 8, 8)).astype(np.float32)
    x[0, 0, :3] = 0.0       # log10 -> -inf
    x[1] = 0.0              # no finite value after LOG10
    x[2, 1, 1] = np.inf
    x[3, 2, 2] = np.nan
    return x


@pytest.mark.parametrize("stretch", ["SQRT", "LOG10"])
def test_apply_stretch_matches_jax(stretch):
    x = _stretch_input(np.random.default_rng(6))
    got = P.apply_stretch(_t(x), stretch).numpy()
    want = np.asarray(JP.apply_stretch(jnp.asarray(x), stretch))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_normalize_by_median_matches_jax(complex_):
    rng = np.random.default_rng(7)
    x = _stretch_input(rng)[:, :, :7]  # odd count: the true median
    x[2] = -1.0  # non-positive median: left as it is
    if complex_:
        x = (x * np.exp(1j * rng.uniform(0, 6, x.shape))).astype(np.complex64)
    got = P.normalize_by_median(_t(x)).numpy()
    want = np.asarray(JP.normalize_by_median(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


def _jax_kept(has, k):
    """The deterministic part of JAX's static_select_from_has
    (pipeline.py), before its permutation."""
    has = jnp.asarray(has)
    order = jnp.argsort(jnp.where(has, 0, 1), stable=True)
    n_f = has.sum()
    denom = jnp.maximum(jnp.where(n_f > 0, n_f, has.shape[0]), 1)
    return np.asarray(jnp.take(order, jnp.arange(k) % denom))


@pytest.mark.parametrize("n_flagged, k", [(5, 24), (30, 24), (0, 24), (40, 40)])
def test_static_select_kept_bit_equal(n_flagged, k):
    rng = np.random.default_rng(n_flagged)
    has = np.zeros(40, bool)
    has[rng.choice(40, n_flagged, replace=False)] = True
    kept = P.static_select_kept(_t(has), k).numpy()
    np.testing.assert_array_equal(kept, _jax_kept(has, k))
    # the shuffled selections are permutations of the same multiset
    g = torch.Generator().manual_seed(0)
    keep = P.static_select_from_has(_t(has), k, g).numpy()
    jkeep = np.asarray(JP.static_select_from_has(jnp.asarray(has), k,
                                                 jax.random.key(0)))
    np.testing.assert_array_equal(np.sort(keep), np.sort(jkeep))
    np.testing.assert_array_equal(np.sort(keep), np.sort(kept))


# -- make_static_prep_fn given JAX's keep ------------------------------------

def _jax_keep(has, k, seed):
    return np.asarray(JP.static_select_from_has(jnp.asarray(has.numpy()), k,
                                                jax.random.key(seed)))


STATIC_CASES = [
    # extract, flags_mode, k
    ("auto", "custom", 40),      # K > M = 32: extract on base (K1's route)
    ("auto", "custom", 24),      # K < M: extract the gathered patches
    ("base", "custom", 24),
    ("gathered", "custom", 40),
    ("planes", "custom", 40),    # K2 + K3's route
    ("auto", "mad", 40),         # K5 on the base patches
    ("planes", "mad", 24),
]


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("extract, flags_mode, k", STATIC_CASES)
def test_static_prep_from_jax_keep(extract, flags_mode, k, use_kernels):
    wf, mask = _waterfalls(np.random.default_rng(8))
    seed = 3
    jfn = JS.make_static_prep_fn(PATCH, k, 4, flags_mode=flags_mode,
                                 extract=extract)
    jimages, jlabels, jpatches, _ = jfn(jnp.asarray(wf), jnp.asarray(mask),
                                        jax.random.key(seed))
    prep = S.make_static_prep_fn(PATCH, k, 4, flags_mode=flags_mode,
                                 use_kernels=use_kernels, extract=extract)
    b = prep.base(_t(wf), _t(mask))
    keep = _jax_keep(b.has, k, seed)
    images, labels, patches, flag_patches = prep.from_keep(b, _t(keep))
    assert images.shape == (k, PATCH, PATCH, 3) and images.dtype == torch.float32
    assert labels.dtype == torch.uint8
    _close(images, jimages)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jpatches))
    assert torch.equal(flag_patches, labels.bool())


@pytest.mark.parametrize("stretch", [None, "SQRT"])
def test_static_prep_real_input_from_jax_keep(stretch):
    wf, _ = _waterfalls(np.random.default_rng(9), complex_=False)
    k, seed = 40, 4
    jfn = JS.make_static_prep_fn(PATCH, k, 4, flags_mode="mad", flag_sigma=4.0,
                                 stretch=stretch, normalize_after_stretch=True)
    jimages, jlabels, _, _ = jfn(jnp.asarray(wf), jnp.asarray(wf),
                                 jax.random.key(seed))
    prep = S.make_static_prep_fn(PATCH, k, 4, flags_mode="mad", flag_sigma=4.0,
                                 stretch=stretch, normalize_after_stretch=True)
    b = prep.base(_t(wf), _t(wf))
    images, labels, _, _ = prep.from_keep(b, _t(_jax_keep(b.has, k, seed)))
    _close(images, jimages)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


def test_static_prep_call_selects_and_keeps():
    wf, mask = _waterfalls(np.random.default_rng(10))
    prep = S.make_static_prep_fn(PATCH, 40, return_patches=False)
    g = torch.Generator().manual_seed(1)
    images, labels, patches, _ = prep(_t(wf), _t(mask), g)
    assert patches is None and images.shape == (40, PATCH, PATCH, 3)
    b = prep.base(_t(wf), _t(mask))
    np.testing.assert_array_equal(
        np.sort(prep.keep.numpy()),
        np.sort(P.static_select_kept(b.has, 40).numpy()))
    assert bool(labels.reshape(40, -1).any(dim=1).all())  # flagged first


def test_static_prep_rejects_partial_patches():
    prep = S.make_static_prep_fn(PATCH, 8)
    with pytest.raises(ValueError, match="whole patches"):
        prep(torch.zeros(1, 40, 64, dtype=torch.complex64),
             torch.zeros(1, 40, 64), torch.Generator())


# -- Preprocessor.create_dataset ---------------------------------------------

def _by_keep(keep, *arrays):
    order = np.argsort(np.asarray(keep), kind="stable")
    return [np.asarray(a)[order] for a in arrays]


@pytest.mark.parametrize("extract", ["auto", "planes"])
def test_create_dataset_static_matches_jax(extract):
    wf, mask = _waterfalls(np.random.default_rng(11))
    k = 40
    jds = JaxPreprocessor(wf[:, None], flags=mask[:, None]).create_dataset(
        patch_size=PATCH, seed=5, static_num_patches=k, use_pallas=False)
    pre = Preprocessor(wf[:, None], flags=mask[:, None], device="cpu")
    ds = pre.create_dataset(patch_size=PATCH, seed=5, static_num_patches=k,
                            extract=extract)
    assert len(ds) == k and ds.images.shape == (k, PATCH, PATCH, 3)
    # the JAX keep from the same any-flag vector and key
    prep = S.make_static_prep_fn(PATCH, k)
    jkeep = _jax_keep(prep.base(_t(wf), _t(mask)).has, k, 5)
    img, lab = _by_keep(pre.keep.numpy(), ds.images.numpy(), ds.labels.numpy())
    jimg, jlab = _by_keep(jkeep, jds.images, jds.labels)
    _close(img, jimg)
    np.testing.assert_array_equal(lab, jlab)
    # the raw patches, on demand
    np.testing.assert_array_equal(
        pre.patches.numpy(),
        S.transform_by_variant(
            P.patchify_batch(_t(wf), PATCH)[_base_index(pre.keep, wf.shape)],
            (pre.keep // 16 % 4)).numpy())


def _base_index(keep, shape):
    m, h, w = shape
    nh, nw = h // PATCH, w // PATCH
    kpp = nh * nw
    remap = torch.from_numpy(S.variant_remap(nh, nw, 4)).long().reshape(-1)
    v = keep // kpp % 4
    return keep // (4 * kpp) * kpp + remap[v * kpp + keep % kpp]


@pytest.mark.parametrize("kwargs", [
    {"seed": 3},
    {"seed": 3, "pad_to_multiple": 16},
    {"seed": 3, "num_patches": 10},
    {"seed": 3, "augmentation_rotations": 2},
    {"inference_mode": True},
    {"seed": 2, "use_custom_flags": False, "flag_sigma": 5},
], ids=["plain", "pad16", "num10", "rot2", "inference", "mad"])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_create_dataset_materialised_matches_jax(kwargs, use_kernels):
    wf, mask = _waterfalls(np.random.default_rng(12), h=48, w=56)
    jds = JaxPreprocessor(wf, flags=mask).create_dataset(
        patch_size=PATCH, use_pallas=False, **kwargs)
    ds = Preprocessor(wf, flags=mask, device="cpu").create_dataset(
        patch_size=PATCH, use_kernels=use_kernels, **kwargs)
    assert ds.images.shape == tuple(np.shape(jds.images))
    _close(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels.numpy(), np.asarray(jds.labels))
    assert ds.metadata["augmentation_rotations"] == jds.metadata["augmentation_rotations"]


def test_create_dataset_static_on_padded_grid_matches_jax():
    """static_num_patches on a grid that is not whole patches takes the
    materialised path with the static selection."""
    wf, mask = _waterfalls(np.random.default_rng(13), h=48, w=56)
    k = 24
    jds = JaxPreprocessor(wf, flags=mask).create_dataset(
        patch_size=PATCH, seed=1, static_num_patches=k, use_pallas=False)
    pre = Preprocessor(wf, flags=mask, device="cpu")
    ds = pre.create_dataset(patch_size=PATCH, seed=1, static_num_patches=k)
    fp, _ = JPP._augment_and_patchify(jnp.asarray(mask), PATCH, 4, True)
    jkeep = np.asarray(JP.static_select_flagged(fp, k, jax.random.key(1)))
    img, lab = _by_keep(pre.keep.numpy(), ds.images.numpy(), ds.labels.numpy())
    jimg, jlab = _by_keep(jkeep, jds.images, jds.labels)
    _close(img, jimg)
    np.testing.assert_array_equal(lab, jlab)


def test_create_dataset_real_input_matches_jax():
    wf, mask = _waterfalls(np.random.default_rng(14), h=48, w=48, complex_=False)
    kwargs = dict(patch_size=PATCH, seed=4, stretch="LOG10",
                  normalize_after_stretch=True, use_custom_flags=False)
    jds = JaxPreprocessor(wf, flags=mask).create_dataset(use_pallas=False, **kwargs)
    ds = Preprocessor(wf, flags=mask, device="cpu").create_dataset(**kwargs)
    _close(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels.numpy(), np.asarray(jds.labels))


@pytest.mark.parametrize("route, wrappers", [
    ("auto", ["fused_gather_extract", "fused_plane_gather_transform_images"]),
    ("planes", ["fused_extract_channel_planes", "fused_plane_gather_transform_images"]),
    ("gathered", ["fused_extract_channels"]),
    ("materialised", ["fused_extract_channels"]),
])
def test_real_input_goes_through_the_kernel_wrappers(monkeypatch, route, wrappers):
    """With use_kernels, real input reaches the kernels' wrappers on every
    route (on the card they launch; here they run their plain versions),
    and gives the images of use_kernels=False."""
    wf, mask = _waterfalls(np.random.default_rng(15), complex_=False)
    calls = []
    for name in wrappers:
        def record(*args, _name=name, _fn=getattr(ops, name)):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(ops, name, record)
    # K=40 exceeds the 32 base patches, so 'auto' takes K1
    size = ({"num_patches": 40} if route == "materialised"
            else {"static_num_patches": 40, "extract": route})
    out = {}
    for use_kernels in (True, False):
        ds = Preprocessor(wf, flags=mask, device="cpu").create_dataset(
            patch_size=PATCH, seed=2, use_kernels=use_kernels, **size)
        out[use_kernels] = ds.images
    assert calls == wrappers
    assert torch.equal(out[True], out[False])
