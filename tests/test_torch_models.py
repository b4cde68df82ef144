"""Port parity: the UNet, its Flax weight conversion and BatchNorm folding
against the JAX package, on the CPU.

Tolerances: 1e-4 on the logits of small random UNets (float32, different
conv summation order), 1e-3 on the shipped UNet16 snapshots (deeper,
wider, logits up to ~15)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.models import UNet as FlaxUNet
from rfi_toolbox_tpu.models import fold_batchnorm as flax_fold_batchnorm
from rfi_toolbox_tpu.train.trainer import load_params as flax_load_params
from rfi_toolbox_tpu_torch.models import (
    UNet,
    depth_to_space,
    fold_batchnorm,
    load_params,
    params_from_flax,
    space_to_depth,
    unet_from_snapshot,
)
from rfi_toolbox_tpu.models import depth_to_space as flax_depth_to_space
from rfi_toolbox_tpu.models import space_to_depth as flax_space_to_depth

SNAPSHOTS = ["pretrained/unet16_synthetic.npz", "pretrained/unet16gn_universal.npz"]


def _random_variables(shapes, rng, key=""):
    """Seeded numpy values for a Flax variable tree given by its shapes:
    conv kernels ~ N(0, 1/fan_in) (activations stay O(1)), norm scales
    and batch variances in [0.5, 1.5], biases and batch means ~ 0.3 N(0, 1)."""
    if isinstance(shapes, dict):
        return {k: _random_variables(v, rng, k) for k, v in shapes.items()}
    shape = shapes.shape
    if key == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    if key in ("var", "scale"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return (0.3 * rng.normal(size=shape)).astype(np.float32)


def _flax_unet(rng, norm, s2d=False, features=4, hw=32):
    model = FlaxUNet(init_features=features, norm=norm, space_to_depth=s2d)
    # shapes only: tracing the init is far cheaper than running it
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, hw, hw, 3)))
    variables = _random_variables(dict(shapes), rng)
    return model, variables["params"], variables.get("batch_stats", {})


def _port_unet(params, stats, norm, s2d=False, features=4):
    model = UNet(in_channels=3, init_features=features, norm=norm,
                 space_to_depth=s2d)
    model.load_state_dict(params_from_flax(params, stats, model))
    return model.eval()


def _port_logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2))[:, 0].numpy()


def _flax_logits(model, params, stats, x):
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    out = apply({"params": params, "batch_stats": stats}, x)
    return np.asarray(out)[..., 0]


@pytest.mark.parametrize("norm,s2d", [("batch", False), ("group", False),
                                      ("none", False), ("group", True)])
def test_converted_unet_matches_flax(rng, norm, s2d):
    model, params, stats = _flax_unet(rng, norm, s2d)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = _flax_logits(model, params, stats, x)
    got = _port_logits(_port_unet(params, stats, norm, s2d), x)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_space_to_depth_matches_flax(rng):
    x = rng.normal(size=(2, 8, 6, 3)).astype(np.float32)
    want = np.asarray(flax_space_to_depth(x))
    got = space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    y = rng.normal(size=(2, 4, 3, 8)).astype(np.float32)
    want = np.asarray(flax_depth_to_space(y))
    got = depth_to_space(torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_group_norm_groups_and_eps():
    model = UNet(init_features=12, norm="group")
    gn = model.encoders[0].block.norm1
    assert gn.num_groups == 4 and gn.eps == 1e-6  # gcd(12, 8), flax eps
    bn = UNet(init_features=4).encoders[0].block.norm1
    assert bn.eps == 1e-5


def test_fold_batchnorm_matches_unfolded_and_flax(rng):
    model, params, stats = _flax_unet(rng, "batch")
    port = _port_unet(params, stats, "batch")
    folded = fold_batchnorm(port)
    assert folded.norm == "none" and port.norm == "batch"
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = _port_logits(folded, x)
    np.testing.assert_allclose(got, _port_logits(port, x), atol=1e-4, rtol=0)
    fmodel, fparams = flax_fold_batchnorm(model, params, stats)
    want = _flax_logits(fmodel, jax.device_get(fparams), {}, x)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fold_batchnorm_rejects_group_norm():
    with pytest.raises(ValueError, match="norm='batch'"):
        fold_batchnorm(UNet(init_features=4, norm="group"))


def test_conversion_rejects_mismatched_architecture(rng):
    _, params, stats = _flax_unet(rng, "batch")
    with pytest.raises(ValueError, match="does not match"):
        params_from_flax(params, stats, UNet(init_features=4, norm="group"))


def test_load_params_matches_flax_loader():
    params, stats, meta = load_params(SNAPSHOTS[0])
    fparams, fstats, fmeta = flax_load_params(SNAPSHOTS[0])
    assert meta == fmeta
    for got, want in ((params, fparams), (stats, fstats)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", SNAPSHOTS)
def test_shipped_snapshot_logits(rng, path):
    params, stats, meta = flax_load_params(path)
    fmodel = FlaxUNet(init_features=int(meta["init_features"]),
                      norm=meta.get("norm", "batch"))
    x = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    want = _flax_logits(fmodel, params, stats, x)
    model, _ = unet_from_snapshot(path)
    assert model.init_features == 16 and model.in_channels == 3
    np.testing.assert_allclose(_port_logits(model, x), want, atol=1e-3, rtol=0)
