"""Port parity: the coherent 8-channel path (``coherent_batch``,
``flag_waterfalls_coherent``, the coherent snapshots, ``CoherentTrainer``)
against the JAX package, on the CPU.

Tolerances:
- robust-scaled images 1e-5 relative and 1e-6 absolute
  (tests/test_coherent_trainer.py's bounds): ``torch.nanquantile`` and
  JAX's quantiles agree to an ulp (XLA fuses JAX's linear interpolation);
- flags equal, with one predictor shared by both packages;
- the shipped snapshots' probabilities within 1e-4, masks equal on
  99.9% of the pixels (the BatchNorm one folded, as ``CompiledPredictor``
  serves it);
- the learning-rate schedule bit-equal to optax's (measured at 606 counts);
- three float32 train steps at a constant learning rate: losses 1e-5
  relative; parameters and EMA as tests/test_torch_train.py holds them
  (within 2 * lr per step, and the update within 1e-3 * lr of JAX's on
  99.5% of the coordinates whose gradient is well above Adam's eps);
  BatchNorm statistics 1e-5 relative;
- a resumed run bit-equal to the uninterrupted one on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import random

from rfi_toolbox_tpu.io.flagging import _coherent_images as jax_coherent_images
from rfi_toolbox_tpu.io.flagging import flag_waterfalls_coherent as jax_flag_coherent
from rfi_toolbox_tpu.models import UNet as FlaxUNet
from rfi_toolbox_tpu.synth.simulator import RFISimulator as JaxSimulator
from rfi_toolbox_tpu.train import CoherentTrainer as JaxCoherentTrainer
from rfi_toolbox_tpu.train import coherent_batch as jax_coherent_batch
from rfi_toolbox_tpu.train import load_params as jax_load_params
from rfi_toolbox_tpu_torch.io import flag_waterfalls_coherent
from rfi_toolbox_tpu_torch.io.flagging import coherent_images
from rfi_toolbox_tpu_torch.models import params_from_flax, params_to_flax
from rfi_toolbox_tpu_torch.serving import CompiledPredictor
from rfi_toolbox_tpu_torch.train import CoherentTrainer, warmup_cosine_decay_schedule
from rfi_toolbox_tpu_torch.train.coherent_trainer import robust_scale, to_8ch

LR = 1e-4  # test_torch_train.py's
SIZE = 32  # the JAX trainer tests' sample size


@functools.cache
def _jax_tf(size, n=2, seed=7):
    """JAX simulator planes (n, 4, T, F) and masks of ``coherent_batch``'s keys."""
    sim = JaxSimulator(size, size, seed=0)
    tf, mask = jax.vmap(sim.generate_rfi_device)(random.split(random.key(seed), n))
    return np.array(tf), np.array(mask)


def _vis4(size, c, t):
    """(2, 4, c, t) complex64 waterfalls cut from JAX simulator planes."""
    return np.ascontiguousarray(_jax_tf(size)[0][:, :, :c, :t])


def _shared_predictor(images):
    """A predictor both packages call: a fixed cut of two channels."""
    x = np.asarray(images)
    return x[..., 0] + 0.5 * x[..., 7] > 0.3


def test_coherent_batch_matches_jax():
    size = 64
    x, gt = jax_coherent_batch(random.key(7), 2, size)
    tf, mask = _jax_tf(size)
    got = robust_scale(to_8ch(torch.from_numpy(tf)))
    assert got.shape == (2, size, size, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(x), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(mask > 0.5, np.asarray(gt))


def test_to_8ch_channel_order():
    tf = torch.complex(torch.arange(4.0).view(4, 1, 1), 10 + torch.arange(4.0).view(4, 1, 1))
    assert to_8ch(tf)[0, 0].tolist() == [0, 10, 1, 11, 2, 12, 3, 13]


@pytest.mark.parametrize("c, t", [(64, 64), (50, 61)], ids=["divisible", "ragged"])
def test_flag_waterfalls_coherent_matches_jax(c, t):
    vis4 = _vis4(64, c, t)
    want_images = np.asarray(jax_coherent_images(jnp.asarray(vis4), 32))
    got_images = coherent_images(torch.from_numpy(vis4), 32)
    np.testing.assert_allclose(got_images.numpy(), want_images, rtol=1e-5, atol=1e-6)
    want = np.asarray(jax_flag_coherent(vis4, _shared_predictor, patch_size=32))
    got = flag_waterfalls_coherent(vis4, _shared_predictor, patch_size=32, device="cpu")
    assert got.shape == (2, c, t) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95


def test_flag_waterfalls_coherent_cuts_probabilities():
    vis4 = _vis4(64, 64, 64)
    probs = flag_waterfalls_coherent(vis4, lambda x: torch.sigmoid(x[..., 0]),
                                     patch_size=32, threshold=0.6, device="cpu")
    want = np.asarray(jax_flag_coherent(vis4, lambda x: jax.nn.sigmoid(jnp.asarray(x)[..., 0]),
                                        patch_size=32, threshold=0.6))
    np.testing.assert_array_equal(probs.numpy(), want)
    with pytest.raises(ValueError, match="4-pol"):
        flag_waterfalls_coherent(vis4[:, :3], _shared_predictor, device="cpu")


@pytest.mark.parametrize("name", ["unet16_coherent8ch", "unet16gn_coherent8ch",
                                  "unet16gn_s2d_coherent8ch"])
def test_coherent_snapshot_matches_jax(name):
    path = f"pretrained/{name}.npz"
    params, stats, meta = jax_load_params(path)
    model = FlaxUNet(init_features=meta["init_features"], norm=meta.get("norm", "batch"),
                     space_to_depth=bool(meta.get("space_to_depth", False)))
    x, _ = jax_coherent_batch(random.key(123), 2, 128)
    logits = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        {"params": params, "batch_stats": stats}, x)
    want = np.asarray(jax.nn.sigmoid(logits[..., 0]))
    pred = CompiledPredictor.from_snapshot(path, batch_size=2, device="cpu")
    assert pred.input_shape == (128, 128, 8) and pred.model.in_channels == 8
    assert pred.folded == (meta.get("norm", "batch") == "batch")
    assert pred.model.space_to_depth == bool(meta.get("space_to_depth", False))
    got = torch.sigmoid(pred.logits(torch.from_numpy(np.array(x)))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    th = float(meta["best_threshold"])
    agree = (pred(np.asarray(x)).numpy() == (want > th)).mean()
    assert agree >= 0.999, agree


@pytest.mark.parametrize("decay_steps", [501, 36_000])
def test_schedule_matches_optax(decay_steps):
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 500, decay_steps, end_value=1e-5)
    got = warmup_cosine_decay_schedule(0.0, 1e-3, 500, decay_steps, end_value=1e-5)
    mid = (500 + decay_steps) // 2
    for count in (0, 1, 250, 499, 500, 501, mid, decay_steps - 1, decay_steps,
                  decay_steps + 1000):
        assert got(count) == float(want(count)), count


def test_schedule_is_read_at_the_count_before_the_update():
    """optax evaluates the schedule at the count of updates applied: the
    first update of the warmup has learning rate 0 and moves nothing."""
    tr = CoherentTrainer(init_features=2, size=SIZE, batch_size=1, device="cpu")
    tr._build_schedule(1000)
    tr._init()
    start = [p.detach().clone() for p in tr.state.params]
    x, y = tr.sample(0)
    tr.train_step(x, y)
    assert all(torch.equal(a, b) for a, b in zip(start, tr.state.params))
    tr.train_step(x, y)
    assert not all(torch.equal(a, b) for a, b in zip(start, tr.state.params))
    assert tr.step == 2


def _jax_trainer(norm, learning_rate=LR, num_steps=3):
    """A JAX CoherentTrainer set up as ``fit`` sets it up, its UNet's init
    jitted (run eagerly it compiles op by op)."""
    tr = JaxCoherentTrainer(init_features=4, size=SIZE, batch_size=2, seed=2, norm=norm,
                            learning_rate=learning_rate, dtype=jnp.float32)
    tr._build_tx(num_steps)
    init = jax.jit(tr.model.init, static_argnames="train")
    variables = init(random.key(tr.seed), jnp.zeros((1, SIZE, SIZE, 8)), train=False)
    tr.params = variables["params"]
    tr.batch_stats = variables.get("batch_stats", {})
    tr.opt_state = tr.tx.init(tr.params)
    tr.ema_params = jax.tree.map(jnp.copy, tr.params)
    return tr


def _port_trainer(jtr, norm):
    tr = CoherentTrainer(init_features=4, size=SIZE, batch_size=2, seed=2, norm=norm,
                         learning_rate=LR, device="cpu")
    tr._build_schedule(3)
    tr._init()
    model = tr.state.model
    model.load_state_dict(params_from_flax(jax.device_get(jtr.params),
                                           jax.device_get(jtr.batch_stats), model))
    tr.ema_params = [p.detach().clone() for p in tr.state.params]
    return tr


def _assert_updates_close(got, want, start, grad_rms, steps):
    """``got``/``want``/``start``: name -> tensor; updates agree as
    tests/test_torch_train.py holds them."""
    errs = []
    for key, w in want.items():
        g = got[key]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2 * LR * steps,
                                   err_msg=key)
        err = ((g.double() - start[key].double()) - (w.double() - start[key].double())).abs()
        errs.append(err[grad_rms[key] >= 100 * 1e-8])
    errs = torch.cat(errs)
    assert errs.numel() >= 0.3 * sum(v.numel() for v in want.values())
    agree = float((errs <= 1e-3 * LR).double().mean())
    assert agree >= 0.995, agree


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_train_steps_match_jax(norm):
    """Three float32 steps from JAX's initial parameters on JAX's own
    batches (its sample function on the keys ``fit`` gives its steps)."""
    steps = 3
    jtr = _jax_trainer(norm)
    ptr = _port_trainer(jtr, norm)
    model = ptr.state.model
    names = [n for n, _ in model.named_parameters()]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    base = random.fold_in(random.key(jtr.seed), 1)
    keys = jax.vmap(lambda i: random.fold_in(base, i))(jnp.arange(steps))
    batches = [jax.vmap(jtr._sample)(random.split(k, jtr.batch_size)) for k in keys]
    jparams, jstats, _, jema, jlosses = jtr._make_fused()(
        jtr.params, jtr.batch_stats, jtr.opt_state, jtr.ema_params, keys)
    plosses = [float(ptr.train_step(torch.from_numpy(np.array(x)),
                                    torch.from_numpy(np.array(y)))) for x, y in batches]
    np.testing.assert_allclose(plosses, np.asarray(jlosses), rtol=1e-5)
    assert ptr.step == steps
    want = params_from_flax(jax.device_get(jparams), jax.device_get(jstats), model)
    got = model.state_dict()
    grad_rms = {n: (v / (1 - 0.999 ** steps)).sqrt() for n, v in zip(names, ptr.state.nu)}
    _assert_updates_close({n: got[n] for n in names}, {n: want[n] for n in names},
                          start, grad_rms, steps)
    want_ema = params_from_flax(jax.device_get(jema), jax.device_get(jstats), model)
    _assert_updates_close(dict(zip(names, ptr.ema_params)), {n: want_ema[n] for n in names},
                          start, grad_rms, steps)
    for key in want:
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_checkpoint_resume_is_bit_equal(tmp_path):
    kwargs = dict(init_features=4, size=64, batch_size=2, device="cpu")
    a = CoherentTrainer(**kwargs)
    a.fit(num_steps=4, fused_steps=2)
    a.save_checkpoint(tmp_path / "ck.pt")
    a.fit(num_steps=4, fused_steps=2)
    b = CoherentTrainer(**kwargs)
    assert b.restore_checkpoint(tmp_path / "ck.pt", num_steps_hint=8) == 4
    b.fit(num_steps=4, fused_steps=2)
    assert b.step == a.step == 8
    for x, y in zip(a.state.model.state_dict().values(), b.state.model.state_dict().values()):
        assert torch.equal(x, y)
    for x, y in zip(a.ema_params + a.state.mu, b.ema_params + b.state.mu):
        assert torch.equal(x, y)


def test_fit_logs_ema_and_stream():
    tr = CoherentTrainer(init_features=4, size=64, batch_size=2, norm="group", device="cpu")
    history = tr.fit(num_steps=6, fused_steps=3, log_every=3)["history"]
    assert [h["step"] for h in history] == [3, 6]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert any(not torch.equal(e, p) for e, p in zip(tr.ema_params, tr.state.params))
    x0, y0 = tr.sample(5)
    x1, y1 = tr.sample(5)
    assert torch.equal(x0, x1) and torch.equal(y0, y1)  # a function of (seed, step)
    assert not torch.equal(tr.sample(6)[0], x0)
    assert x0.shape == (2, 64, 64, 8) and set(y0.unique().tolist()) <= {0.0, 1.0}
    rep = tr.evaluate(num_batches=1, eval_batch=2, thresholds=[0.3, 0.5], tta=True)
    assert set(rep) == {"best_threshold", "best_iou", "ious"}
    assert rep["best_threshold"] in (0.3, 0.5) and 0.0 <= rep["best_iou"] <= 1.0
    gap = tr.calibration_gap(num_batches=1, eval_batch=2, thresholds=[0.4, 0.5])
    assert gap["gap"] == 0.0 and gap["eval_mode"]["ious"] == gap["train_mode"]["ious"]


def test_export_metadata_matches_jax(tmp_path):
    jtr = _jax_trainer("group")
    jpath = jtr.export(tmp_path / "jax.npz", best_threshold=0.4)
    _, jstats, jmeta = jax_load_params(jpath)
    tr = CoherentTrainer(init_features=4, size=SIZE, batch_size=2, norm="group",
                         learning_rate=LR, device="cpu")
    tr.fit(num_steps=1)
    path = tr.export(tmp_path / "port.npz", best_threshold=0.4)
    params, stats, meta = jax_load_params(path)
    assert set(meta) == set(jmeta)
    for key in set(meta) - {"steps"}:
        assert meta[key] == jmeta[key], key
    assert meta["steps"] == 1 and stats == jstats == {}
    # EMA weights are shipped
    shipped = params_to_flax(tr._eval_model())[0]
    for a, b in zip(jax.tree.leaves(shipped), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["unet16gn_s2d_coherent8ch", "unet16_coherent8ch"])
def test_load_jax_exported_snapshot(name):
    path = f"pretrained/{name}.npz"
    params, stats, meta = jax_load_params(path)
    tr = CoherentTrainer.load(path, device="cpu")
    assert tr.size == meta["train_size"][0] and tr.step == 0
    assert tr.model.norm == meta.get("norm", "batch")
    assert tr.model.space_to_depth == bool(meta.get("space_to_depth", False))
    got_params, got_stats = params_to_flax(tr.state.model)
    for a, b in zip(jax.tree.leaves(got_params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(got_stats), jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert all(torch.equal(e, p) for e, p in zip(tr.ema_params, tr.state.params))


def test_coherent_entry_points_want_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoherentTrainer(init_features=2, size=SIZE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flag_waterfalls_coherent(_vis4(64, 64, 64), _shared_predictor)
    assert CoherentTrainer(init_features=2, size=SIZE, device="cpu").model.dtype == torch.float32
