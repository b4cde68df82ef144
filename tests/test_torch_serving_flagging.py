"""Port parity: the serving predictor, flag_waterfalls and the metrics
against the JAX package, on the CPU.

Masks from a model must be equal except at pixels whose probability (on
the JAX side) lies within 1e-4 of the threshold, where float32 rounding
of the two convolution stacks may fall either way. MAD flags and the
metrics must be exact."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.evaluation import evaluate_segmentation as jax_evaluate
from rfi_toolbox_tpu.io import flag_waterfalls as jax_flag_waterfalls
from rfi_toolbox_tpu.models import UNet as FlaxUNet
from rfi_toolbox_tpu.preprocess import pipeline as JP
from rfi_toolbox_tpu.serving import CompiledPredictor as JaxPredictor
from rfi_toolbox_tpu_torch import evaluation as TE
from rfi_toolbox_tpu_torch.io import flag_waterfalls
from rfi_toolbox_tpu_torch.models import UNet, params_from_flax
from rfi_toolbox_tpu_torch.serving import CompiledPredictor

GOLDEN = Path(__file__).parent / "golden" / "oracles.npz"
EDGE = 1e-4
HW = 32


def _random_variables(shapes, rng, key=""):
    if isinstance(shapes, dict):
        return {k: _random_variables(v, rng, k) for k, v in shapes.items()}
    if key == "kernel":
        fan_in = int(np.prod(shapes.shape[:-1]))
        return (rng.normal(size=shapes.shape) / np.sqrt(fan_in)).astype(np.float32)
    if key in ("var", "scale"):
        return rng.uniform(0.5, 1.5, shapes.shape).astype(np.float32)
    return (0.3 * rng.normal(size=shapes.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def small_unet():
    """A seeded 4-feature BatchNorm UNet: (flax model, params, stats)."""
    model = FlaxUNet(init_features=4, norm="batch")
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, HW, HW, 3)))
    v = _random_variables(dict(shapes), np.random.default_rng(7))
    apply = jax.jit(lambda v, x: jax.nn.sigmoid(
        model.apply(v, x, train=False)[..., 0]))
    return model, v["params"], v["batch_stats"], apply


def _port_model(params, stats):
    model = UNet(init_features=4, norm="batch")
    model.load_state_dict(params_from_flax(params, stats, model))
    return model.eval()


def _jax_probs(small_unet, images, tta):
    _, params, stats, apply = small_unet
    v = {"params": params, "batch_stats": stats}
    if not tta:
        return np.asarray(apply(v, images))
    flips = [(), (1,), (2,), (1, 2)]
    p = [np.flip(np.asarray(apply(v, np.flip(images, f).copy())), f)
         for f in flips]
    return (p[0] + p[1] + p[2] + p[3]) / 4


def _assert_masks_agree(got, want, probs, threshold=0.5):
    assert got.shape == want.shape and got.dtype == bool
    differ = got != want
    assert not (differ & (np.abs(probs - threshold) > EDGE)).any()


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("n", [3, 4, 9])
def test_predictor_matches_jax(rng, small_unet, tta, n):
    """Batch padding (3 < 4), one full chunk (4), several chunks (9)."""
    model, params, stats, _ = small_unet
    images = rng.normal(size=(n, HW, HW, 3)).astype(np.float32)
    jax_pred = JaxPredictor(model, params, stats, input_shape=(HW, HW, 3),
                            batch_size=4, tta=tta)
    pred = CompiledPredictor(_port_model(params, stats), input_shape=(HW, HW, 3),
                             batch_size=4, tta=tta, device="cpu")
    assert pred.folded
    got = pred(images)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
    _assert_masks_agree(got.numpy(), np.asarray(jax_pred(images)),
                        _jax_probs(small_unet, images, tta))


def test_predictor_unfolded_and_tensor_input(rng, small_unet):
    _, params, stats, _ = small_unet
    images = rng.normal(size=(5, HW, HW, 3)).astype(np.float32)
    pred = CompiledPredictor(_port_model(params, stats), input_shape=(HW, HW, 3),
                             batch_size=4, fold_norm=False, device="cpu")
    assert not pred.folded
    got = pred(torch.from_numpy(images))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
    probs = _jax_probs(small_unet, images, False)
    _assert_masks_agree(got.numpy(), probs > 0.5, probs)
    assert pred(np.zeros((0, HW, HW, 3), np.float32)).shape == (0, HW, HW)
    with pytest.raises(ValueError, match="expected"):
        pred(np.zeros((1, 16, 16, 3), np.float32))


def test_from_snapshot_reads_metadata(tmp_path, rng, small_unet):
    from rfi_toolbox_tpu.train import export_params

    _, params, stats, _ = small_unet
    path = tmp_path / "m.npz"
    export_params(params, path, batch_stats=stats,
                  metadata={"init_features": 4, "best_threshold": 0.3})
    pred = CompiledPredictor.from_snapshot(path, batch_size=2, device="cpu")
    assert pred.threshold == 0.3 and pred.input_shape == (128, 128, 3)
    assert pred.model.init_features == 4 and pred.folded
    jax_pred = JaxPredictor.from_snapshot(path, input_shape=(HW, HW, 3),
                                          batch_size=2)
    port = CompiledPredictor.from_snapshot(path, input_shape=(HW, HW, 3),
                                           batch_size=2, device="cpu")
    images = rng.normal(size=(3, HW, HW, 3)).astype(np.float32)
    _assert_masks_agree(port(images).numpy(), np.asarray(jax_pred(images)),
                        _jax_probs(small_unet, images, False), threshold=0.3)


def _visibilities(rng, shape):
    amp = rng.normal(1.0, 0.1, shape)
    amp[:, 40:44, :] += 1e4
    amp[:, :, 90:95] += 3e3
    return (amp * np.exp(1j * rng.uniform(0, 2 * np.pi, shape))).astype(np.complex64)


@pytest.mark.parametrize("shape,patch", [((2, 200, 300), 64), ((2, 48, 40), 64),
                                         ((1, 128, 128), 128)])
def test_flag_waterfalls_mad_exact(rng, shape, patch):
    """Patched waterfalls, and one patch that is the whole waterfall."""
    vis = _visibilities(rng, shape)
    want = np.asarray(jax_flag_waterfalls(vis, method="mad", sigma=5.0,
                                          patch_size=patch, use_pallas=False))
    got = flag_waterfalls(vis, method="mad", sigma=5.0, patch_size=patch,
                          device="cpu")
    assert got.dtype == torch.bool and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_flag_waterfalls_mad_real_input_exact(rng):
    x = (3.0 * rng.normal(size=(2, 96, 80))).astype(np.float64)
    x[:, 10] -= 100.0
    want = np.asarray(jax_flag_waterfalls(x, method="mad", patch_size=32,
                                          use_pallas=False))
    got = flag_waterfalls(x, method="mad", patch_size=32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tta", [False, True])
def test_flag_waterfalls_model_matches_jax(rng, small_unet, tta):
    model, params, stats, _ = small_unet
    vis = _visibilities(rng, (2, 80, 100))
    jax_pred = JaxPredictor(model, params, stats, input_shape=(HW, HW, 3),
                            batch_size=8, tta=tta)
    want = np.asarray(jax_flag_waterfalls(vis, method="model", predictor=jax_pred,
                                          patch_size=HW, use_pallas=False))
    pred = CompiledPredictor(_port_model(params, stats), input_shape=(HW, HW, 3),
                             batch_size=8, tta=tta, device="cpu")
    got = flag_waterfalls(vis, method="model", predictor=pred, patch_size=HW,
                          device="cpu").numpy()
    images = np.asarray(JP.imagenet_normalize(JP.extract_channels(
        JP.patchify_batch(vis, HW))))
    probs = np.asarray(JP.unpatchify_batch(
        _jax_probs(small_unet, images, tta), 2, 80, 100))
    _assert_masks_agree(got, want, probs)


def test_flag_waterfalls_model_probability_predictor(rng):
    """A predictor returning probabilities is cut at ``threshold``."""
    vis = _visibilities(rng, (1, 64, 64))

    def log_amp_channel(images):
        return torch.sigmoid(images[..., 1])

    got = flag_waterfalls(vis, method="model", predictor=log_amp_channel,
                          threshold=0.9, patch_size=32, device="cpu")
    assert got.shape == (1, 64, 64) and got[:, 40:44].all()


def test_flag_waterfalls_rejects_bad_arguments(rng):
    vis = _visibilities(rng, (1, 64, 64))
    with pytest.raises(ValueError, match="Unknown method"):
        flag_waterfalls(vis, method="nope", device="cpu")
    with pytest.raises(ValueError, match="requires a predictor"):
        flag_waterfalls(vis, method="model", device="cpu")
    with pytest.raises(ValueError, match="Expected"):
        flag_waterfalls(vis[0], device="cpu")


def _mask_pairs(rng):
    a = rng.random((4, 16, 16)) > 0.6
    b = rng.random((4, 16, 16)) > 0.5
    empty = np.zeros((4, 16, 16), bool)
    return [(a, b), (empty, b), (a, empty), (empty, empty), (a, a), (a, ~a)]


def test_metrics_match_jax(rng):
    for pred, true in _mask_pairs(rng):
        want = jax_evaluate(pred, true)
        got = TE.evaluate_segmentation(torch.from_numpy(pred), true)
        assert got == pytest.approx(want, abs=1e-7)
        assert TE.compute_iou(pred, true) == pytest.approx(want["iou"], abs=1e-7)
        assert TE.compute_precision(pred, true) == pytest.approx(
            want["precision"], abs=1e-7)
        assert TE.compute_recall(pred, true) == pytest.approx(want["recall"], abs=1e-7)
        assert TE.compute_f1(pred, true) == pytest.approx(want["f1"], abs=1e-7)
        assert TE.compute_dice(pred, true) == pytest.approx(want["dice"], abs=1e-7)


def test_metrics_golden():
    with np.load(GOLDEN) as g:
        flags, patches, metrics = g["mad_flags"], g["input_patches"], g["metrics"]
    m = TE.evaluate_segmentation(flags, np.abs(patches) > 1e4)
    got = np.array([m["iou"], m["precision"], m["recall"], m["f1"], m["dice"]])
    np.testing.assert_allclose(got, metrics, atol=1e-6)
