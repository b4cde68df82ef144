"""Port parity: losses, the UNet's training-mode BatchNorm and Flax
initialisers, and the optimiser's train steps against the JAX package,
on the CPU in float32.

Tolerances:
- losses 1e-6 against the same formula in float64, and 1e-5 against the
  JAX function, whose float32 mean on the CPU is itself 3.1e-6 off the
  float64 value at these 4096 pixels;
- train-step losses 1e-4 relative (different conv summation order);
  three float32 steps 1e-5 (measured 3.9e-7 with BatchNorm, 2.9e-7 with
  GroupNorm);
- parameters within 2 * lr per step: Adam's update of a coordinate whose
  gradient is near 0 is ``m / (sqrt(v) + eps)``, of magnitude up to one,
  and may round to either sign. That bound alone would pass an update
  of the wrong sign, so the update itself (parameter minus its start)
  must also agree with JAX's within 1e-3 * lr on 99.5% of the
  coordinates whose gradient is well above Adam's eps (root mean square
  of the port's bias-corrected second moment >= 100 * eps; about half of
  them: the rest, mostly taps that see only the bottleneck's zero
  padding, have no gradient). Measured: 99.94% (BatchNorm, 3 steps),
  99.99% (GroupNorm), 99.998% (one step); Adam with b2 = 0.99 instead of
  0.999 agrees on some 30%. (Within 1e-2 * lr the b2 error would pass.)
  Since the optimiser's scalars are float32 as in optax, 95% of them
  also agree within 1e-4 * lr (measured 97.3% BatchNorm, 99.9%
  GroupNorm over 3 steps).
- BatchNorm running mean and (biased) variance 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.models import UNet as FlaxUNet
from rfi_toolbox_tpu.train import create_train_state as jax_create_train_state
from rfi_toolbox_tpu.train import eval_step as jax_eval_step
from rfi_toolbox_tpu.train import losses as jax_losses
from rfi_toolbox_tpu.train import train_step as jax_train_step
from rfi_toolbox_tpu.train import train_steps as jax_train_steps
from rfi_toolbox_tpu_torch.models import UNet, params_from_flax
from rfi_toolbox_tpu_torch.models.unet import BatchNorm, flax_init_
from rfi_toolbox_tpu_torch.train import (
    bce_dice_loss,
    bce_with_logits_loss,
    create_train_state,
    dice_loss,
    eval_step,
    train_step,
    train_steps,
)

LR = 1e-4
HW = 16
FEATURES = 4


def _batch(rng, s, b):
    images = rng.normal(size=(s, b, HW, HW, 3)).astype(np.float32)
    labels = (rng.random((s, b, HW, HW)) < 0.3).astype(np.uint8)
    labels[..., 4:7, :] = 1  # a stripe the model can learn
    return images, labels


class _JitInit:
    """A Flax model whose ``init`` is jitted: run eagerly, the UNet's init
    compiles op by op (some 35 s on the CPU)."""

    def __init__(self, model):
        self.init = jax.jit(model.init, static_argnames="train")
        self.apply = model.apply


@functools.cache
def _flax_model(norm):
    return _JitInit(FlaxUNet(init_features=FEATURES, norm=norm))


def _jax_state(norm, seed=0):
    """A fresh state from the JAX package's own create_train_state."""
    return jax_create_train_state(_flax_model(norm), jax.random.key(seed),
                                  (1, HW, HW, 3), learning_rate=LR)


def _port_state(jstate, norm):
    model = UNet(init_features=FEATURES, norm=norm)
    model.load_state_dict(params_from_flax(jax.device_get(jstate.params),
                                           jax.device_get(jstate.batch_stats),
                                           model))
    return create_train_state(model, None, learning_rate=LR, device="cpu")


def _start(pstate):
    return {k: v.clone() for k, v in pstate.model.state_dict().items()}


def _assert_params_close(pstate, jstate, norm, steps, start):
    """``start``: the port's state_dict before the steps (JAX's initial
    parameters)."""
    want = params_from_flax(jax.device_get(jstate.params),
                            jax.device_get(jstate.batch_stats),
                            UNet(init_features=FEATURES, norm=norm))
    got = pstate.model.state_dict()
    names = [n for n, _ in pstate.model.named_parameters()]
    grad_rms = {n: (v / (1 - 0.999**steps)).sqrt()
                for n, v in zip(names, pstate.nu)}
    update_err = []
    for key, w in want.items():
        g = got[key]
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=2 * LR * steps, err_msg=key)
            s = start[key].double()
            err = ((g.double() - s) - (w.double() - s)).abs()
            update_err.append(err[grad_rms[key] >= 100 * 1e-8])
    update_err = torch.cat(update_err)
    assert update_err.numel() >= 0.4 * sum(p.numel() for p in pstate.params)
    agree = float((update_err <= 1e-3 * LR).double().mean())
    assert agree >= 0.995, f"updates agree with JAX's on {agree:.5f} of coordinates"
    close = float((update_err <= 1e-4 * LR).double().mean())
    assert close >= 0.95, f"updates within 1e-4 * lr of JAX's on {close:.5f}"


@pytest.mark.parametrize("fn, jfn", [
    (bce_with_logits_loss, jax_losses.bce_with_logits_loss),
    (dice_loss, jax_losses.dice_loss),
    (bce_dice_loss, jax_losses.bce_dice_loss),
], ids=["bce", "dice", "bce_dice"])
def test_losses_match_jax(fn, jfn):
    rng = np.random.default_rng(3)
    logits = (4 * rng.normal(size=(4, 32, 32))).astype(np.float32)
    targets = (rng.random((4, 32, 32)) < 0.2).astype(np.uint8)
    got = float(fn(torch.from_numpy(logits), torch.from_numpy(targets)))
    x, y = logits.astype(np.float64), targets.astype(np.float64)
    p = 1 / (1 + np.exp(-x))
    bce = np.mean(np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x))))
    dice = 1 - (2 * np.sum(p * y) + 1) / (np.sum(p) + np.sum(y) + 1)
    exact = {bce_with_logits_loss: bce, dice_loss: dice,
             bce_dice_loss: bce + dice}[fn]
    want = float(jfn(jnp.asarray(logits), jnp.asarray(targets)))
    assert abs(got - exact) <= 1e-6
    assert abs(got - want) <= 1e-5


def test_losses_compute_in_float32():
    logits = torch.linspace(-3, 3, 64).reshape(1, 8, 8).to(torch.bfloat16)
    loss = bce_dice_loss(logits, torch.ones(1, 8, 8, dtype=torch.uint8))
    assert loss.dtype == torch.float32


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_fresh_flax_state_converts(norm):
    """A fresh create_train_state tree, not only a snapshot, loads into
    the port and gives the same eval-mode logits and loss."""
    jstate = _jax_state(norm, seed=5)
    pstate = _port_state(jstate, norm)
    images, labels = _batch(np.random.default_rng(5), 1, 2)
    jloss, jpred = jax_eval_step(jstate, jnp.asarray(images[0]),
                                 jnp.asarray(labels[0]))
    ploss, ppred = eval_step(pstate, torch.from_numpy(images[0]),
                             torch.from_numpy(labels[0]))
    assert abs(float(ploss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert (ppred.numpy() != np.asarray(jpred)).mean() < 1e-3


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_train_steps_match_jax(norm):
    """Three float32 steps from JAX's initial parameters."""
    steps = 3
    images, labels = _batch(np.random.default_rng(7), steps, 4)
    jstate = _jax_state(norm)
    pstate = _port_state(jstate, norm)
    start = _start(pstate)
    jstate, jlosses = jax_train_steps(jstate, jnp.asarray(images),
                                      jnp.asarray(labels))
    pstate, plosses = train_steps(pstate, torch.from_numpy(images),
                                  torch.from_numpy(labels))
    np.testing.assert_allclose(plosses.numpy(), np.asarray(jlosses), rtol=1e-5)
    assert pstate.step == steps
    _assert_params_close(pstate, jstate, norm, steps, start)


def test_train_step_is_one_of_train_steps():
    images, labels = _batch(np.random.default_rng(9), 2, 2)
    jstate = _jax_state("batch")
    a, b = _port_state(jstate, "batch"), _port_state(jstate, "batch")
    a, losses = train_steps(a, torch.from_numpy(images), torch.from_numpy(labels))
    for s in range(2):
        b, loss = train_step(b, torch.from_numpy(images[s]),
                             torch.from_numpy(labels[s]))
        assert float(loss) == float(losses[s])
    for pa, pb in zip(a.params, b.params):
        assert torch.equal(pa, pb)


def test_single_train_step_matches_jax_running_stats():
    """Flax keeps the biased batch variance in its running statistics,
    with momentum 0.9; nn.BatchNorm2d would keep the unbiased one."""
    images, labels = _batch(np.random.default_rng(11), 1, 2)
    jstate = _jax_state("batch")
    pstate = _port_state(jstate, "batch")
    start = _start(pstate)
    jstate, jloss = jax_train_step(jstate, jnp.asarray(images[0]),
                                   jnp.asarray(labels[0]))
    pstate, ploss = train_step(pstate, torch.from_numpy(images[0]),
                               torch.from_numpy(labels[0]))
    assert abs(float(ploss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    _assert_params_close(pstate, jstate, "batch", 1, start)


def test_batchnorm_running_stats_are_biased():
    torch.manual_seed(0)
    bn = BatchNorm(3).train()
    x = torch.randn(2, 3, 4, 4) * 3 + 1
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    mean = x.mean(dim=(0, 2, 3))
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-7)


def test_bfloat16_compute_keeps_float32_params():
    model = UNet(init_features=FEATURES, dtype=torch.bfloat16)
    state = create_train_state(model, 0, device="cpu")
    images, labels = _batch(np.random.default_rng(13), 2, 2)
    state, losses = train_steps(state, torch.from_numpy(images),
                                torch.from_numpy(labels))
    assert losses.dtype == torch.float32 and bool(torch.isfinite(losses).all())
    assert all(p.dtype == torch.float32 for p in state.params)
    assert state.model.eval()(torch.zeros(1, 3, HW, HW)).dtype == torch.float32


def test_flax_init_statistics():
    """Fresh kernels follow lecun_normal (std sqrt(1/fan_in), truncated at
    2 sigma of the underlying normal); biases 0, norm scales 1."""
    model = flax_init_(UNet(init_features=8),
                       torch.Generator().manual_seed(0))
    w = model.bottleneck.conv2.weight  # fan_in 9 * 128
    fan_in = w[0].numel()
    std = np.sqrt(1.0 / fan_in)
    assert abs(float(w.detach().std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    up = model.decoders[0].up.weight  # (Cin, Cout, 2, 2): fan_in 4 * Cin
    assert abs(float(up.detach().std()) / np.sqrt(1.0 / (4 * up.shape[0])) - 1) < 0.05
    assert float(model.head.bias.abs().max()) == 0.0
    assert float(model.encoders[0].block.norm1.weight.min()) == 1.0
    # the JAX initialiser's spread, for comparison
    jstate = _jax_state("batch", seed=1)
    k = np.asarray(jstate.params["DoubleConv_0"]["Conv_1"]["kernel"])
    assert abs(k.std() / np.sqrt(1.0 / int(np.prod(k.shape[:-1]))) - 1) < 0.05


def test_seeded_states_are_reproducible():
    a = create_train_state(UNet(init_features=FEATURES), 3, device="cpu")
    b = create_train_state(UNet(init_features=FEATURES), 3, device="cpu")
    for pa, pb in zip(a.params, b.params):
        assert torch.equal(pa, pb)


@pytest.mark.parametrize("kwargs", [{}, {"f": 4, "hw": 16}, {"f": 16, "depth": 3}])
def test_flop_count_is_bench_count(kwargs):
    """The port's copy of bench.py's analytic count gives the same numbers
    (2.32 TFLOP per step of 128 at the headline shapes)."""
    import importlib.util
    from pathlib import Path

    from rfi_toolbox_tpu_torch.train.flops import unet_train_flops_analytic

    spec = importlib.util.spec_from_file_location(
        "bench", Path(__file__).resolve().parents[1] / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert unet_train_flops_analytic(128, **kwargs) == \
        bench.unet_train_flops_analytic(128, **kwargs)
    if not kwargs:
        assert round(unet_train_flops_analytic(128) / 1e12, 2) == 2.32


def test_train_state_is_channels_last():
    state = create_train_state(UNet(init_features=FEATURES), 0, device="cpu")
    conv = state.model.encoders[0].block.conv1.weight
    assert conv.is_contiguous(memory_format=torch.channels_last)
    assert all(m.shape == p.shape for m, p in zip(state.mu, state.params))


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_bfloat16_train_steps_match_jax(norm):
    """Three bf16 train steps (UNet with 8 features, 32 x 32, batch 4)
    from JAX's initial parameters, against the JAX UNet with
    ``dtype=bfloat16`` on the same numpy batches.

    The two frameworks round to bf16 at different places (XLA's and
    oneDNN's bf16 convolutions), so the paths agree only to bf16 noise.
    Bounds, from a measurement over seeds 0 and 1 and both norms:
    losses within 1e-3 relative (measured at most 1.8e-4; 5.7e-5 and
    4.2e-5 here); the first training-mode logits within 5e-2 in root
    mean square relative to JAX's (measured 2.1e-2 and 1.4e-2); the
    cosine between the two paths' 3-step parameter updates at least 0.7
    (measured 0.84 and 0.88; Adam turns the bf16 gradient noise of
    near-zero coordinates into whole steps of lr). At this size a
    float32 port lands as close to JAX's bf16 numbers, so the test also
    checks that the convolutions really run in bf16.
    """
    features, hw, steps = 8, 32, 3
    flax_model = _JitInit(FlaxUNet(init_features=features, norm=norm,
                                   dtype=jnp.bfloat16))
    jstate = jax_create_train_state(flax_model, jax.random.key(0),
                                    (1, hw, hw, 3), learning_rate=LR)
    model = UNet(init_features=features, norm=norm, dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(jax.device_get(jstate.params),
                                           jax.device_get(jstate.batch_stats),
                                           model))
    pstate = create_train_state(model, None, learning_rate=LR, device="cpu")
    rng = np.random.default_rng(7)
    images = rng.normal(size=(steps, 4, hw, hw, 3)).astype(np.float32)
    labels = (rng.random((steps, 4, hw, hw)) < 0.3).astype(np.uint8)
    labels[..., 4:7, :] = 1

    def logits_jax(variables, x):
        out, _ = flax_model.apply(variables, x, train=True,
                                  mutable=["batch_stats"])
        return out[..., 0]

    want = np.asarray(jax.jit(logits_jax)(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(images[0])), np.float64)
    conv_dtypes = []
    hook = pstate.model.encoders[0].block.conv1.register_forward_hook(
        lambda m, i, o: conv_dtypes.append(o.dtype))
    with torch.no_grad():
        got = pstate.model.train()(torch.from_numpy(images[0]).permute(0, 3, 1, 2))
    hook.remove()
    got = got[:, 0].double().numpy()
    assert conv_dtypes == [torch.bfloat16]
    rms = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
    assert rms <= 5e-2, rms

    # the forward above updated the running statistics: start again
    model.load_state_dict(params_from_flax(jax.device_get(jstate.params),
                                           jax.device_get(jstate.batch_stats),
                                           model))
    start = _start(pstate)
    jstate, jlosses = jax_train_steps(jstate, jnp.asarray(images),
                                      jnp.asarray(labels))
    pstate, plosses = train_steps(pstate, torch.from_numpy(images),
                                  torch.from_numpy(labels))
    np.testing.assert_allclose(plosses.numpy(), np.asarray(jlosses), rtol=1e-3)
    jparams = params_from_flax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats),
                               UNet(init_features=features, norm=norm))
    names = [n for n, _ in pstate.model.named_parameters()]
    got_u = torch.cat([(pstate.model.state_dict()[n] - start[n]).double().flatten()
                       for n in names])
    want_u = torch.cat([(jparams[n] - start[n]).double().flatten() for n in names])
    cos = float(got_u @ want_u / (got_u.norm() * want_u.norm()))
    assert cos >= 0.7, cos
