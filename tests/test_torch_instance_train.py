"""Port parity: SOLOLite's instance generator and ``InstanceTrainer``
against the JAX package, on the CPU.

- Train steps: three float32 ``make_instance_train_step`` steps from
  JAX's initial parameters on JAX's own batches (its sample function on
  the keys ``fit`` gives its steps): losses within 1e-5 relative, the
  parameters' updates within 1e-4 * lr of JAX's on at least 97% of the
  coordinates (tests/test_torch_train.py's bound for the UNet).
- The generator, whose random stream cannot be JAX's, by structure and
  statistics: shapes and dtypes, class ids per family, padded rows
  invalid and empty, valid masks non-empty, the waterfall's magnitude at
  least ``pmin * 1000`` inside the masks, per-family counts within their
  ranges over 256 samples, per-family mean counts within 4 standard
  errors of their uniform law's (both packages), and mean event areas
  within 4 standard errors of JAX's (256 samples each).
- The trainer: ``fused_steps`` bit-equal to one step at a time, a second
  ``fit`` continuing the stream, a checkpoint restored repeating the
  next steps, snapshots bit-equal both ways with JAX's
  ``InstanceTrainer``, real-patch mixing, the held-out evaluation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from rfi_toolbox_tpu.models import instance as JI
from rfi_toolbox_tpu.synth.sample import make_instance_sample_generator as jax_generator
from rfi_toolbox_tpu.train import InstanceTrainer as JaxInstanceTrainer
from rfi_toolbox_tpu_torch.evaluation import evaluate_instance_model
from rfi_toolbox_tpu_torch.models import SOLOLite, sololite_from_flax, sololite_to_flax
from rfi_toolbox_tpu_torch.synth import events as E
from rfi_toolbox_tpu_torch.synth import make_instance_sample_generator
from rfi_toolbox_tpu_torch.train import InstanceTrainer, make_instance_train_step

LR = 1e-3  # InstanceTrainer's default
SIZE, GRID, FEATURES, EMBED = 32, 4, 8, 16
ALL_SIX = {
    "narrowband_persistent": {"count": [1, 3]},
    "broadband_persistent": {"count": [0, 2]},
    "narrowband_intermittent": {"count": [0, 2]},
    "narrowband_bursty": {"count": [0, 2]},
    "broadband_bursty": {"count": [0, 1]},
    "frequency_sweep": {"count": [0, 1]},
}
TARGETS = ("inst_masks", "inst_classes", "inst_valid")


def _small_model(features=FEATURES, embed=EMBED):
    return SOLOLite(num_classes=6, grid_size=GRID, embed_dim=embed, features=features)


def _trainer(**kwargs):
    kwargs = {"model": _small_model(4, 8), "patch_size": SIZE, "batch_size": 2,
              "device": "cpu", **kwargs}
    return InstanceTrainer(**kwargs)


def test_train_steps_match_jax():
    steps = 3
    model = JI.SOLOLite(num_classes=6, grid_size=GRID, embed_dim=EMBED, features=FEATURES)
    jtr = JaxInstanceTrainer(model=model, patch_size=SIZE, batch_size=4, rfi_config=ALL_SIX,
                             learning_rate=LR, use_pallas=False)
    init = jax.jit(model.init)
    params = init(random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    opt_state = jtr.tx.init(params)
    ptr = InstanceTrainer(model=_small_model(), patch_size=SIZE, batch_size=4,
                          rfi_config=ALL_SIX, learning_rate=LR, device="cpu")
    ptr._init()
    pmodel = ptr.state.model
    pmodel.load_state_dict(sololite_from_flax(jax.device_get(params), pmodel))
    start = {k: v.clone() for k, v in pmodel.state_dict().items()}
    step = make_instance_train_step()
    base = random.fold_in(random.key(jtr.seed), 1)
    jlosses, plosses = [], []
    for i in range(steps):
        batch = jtr.generate_batch(random.fold_in(base, i))
        args = [np.array(batch[k]) for k in ("waterfall",) + TARGETS]
        params, opt_state, loss, _ = jtr._step(params, opt_state, *map(jnp.asarray, args))
        jlosses.append(float(loss))
        _, loss, parts = step(ptr.state, *map(torch.from_numpy, args))
        plosses.append(float(loss))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    assert ptr.step == steps
    want = sololite_from_flax(jax.device_get(params), pmodel)
    got = pmodel.state_dict()
    errs = torch.cat([((got[k].double() - start[k].double())
                       - (want[k].double() - start[k].double())).abs().flatten()
                      for k in want])
    close = float((errs <= 1e-4 * LR).double().mean())
    assert close >= 0.97, f"updates within 1e-4 * lr of JAX's on {close:.5f}"
    for k in want:  # and every coordinate within a step's reach
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=2 * LR * steps, err_msg=k)


MIXES = {"all6": ALL_SIX,
         "default": {"narrowband_persistent": {"count": [1, 3]},
                     "broadband_persistent": {"count": [0, 2]},
                     "narrowband_bursty": {"count": [0, 2]},
                     "frequency_sweep": {"count": [0, 1]}}}


@functools.cache
def _port_samples(mix_name, n=256, size=64):
    fn = make_instance_sample_generator(size, size, rfi_config=MIXES[mix_name], device="cpu")
    return fn(n, torch.Generator().manual_seed(0))


@functools.cache
def _jax_samples(mix_name, n=256, size=64):
    fn = jax.jit(jax.vmap(jax_generator(size, size, rfi_config=MIXES[mix_name])))
    return {k: np.array(v) for k, v in fn(random.split(random.key(0), n)).items()}


def _layout(mix):
    """(type, lo, hi) of each family in row order: the separable types in
    ``SEPARABLE_TYPES`` order, then the sweeps."""
    rows = []
    for name in list(E.SEPARABLE_TYPES) + ["frequency_sweep"]:
        count = mix.get(name, {}).get("count", 0)
        lo, hi = (count, count) if isinstance(count, int) else count
        if hi > 0:
            rows.append((name, lo, hi))
    return rows


@pytest.mark.parametrize("mix_name", ["all6", "default"])
def test_generator_structure(mix_name):
    out = _port_samples(mix_name)
    layout = _layout(MIXES[mix_name])
    m = sum(hi for _, _, hi in layout)
    wf, masks, classes, valid = (out[k] for k in ("waterfall",) + TARGETS)
    assert wf.shape == (256, 64, 64) and wf.dtype == torch.complex64
    assert masks.shape == (256, m, 64, 64) and masks.dtype == torch.bool
    assert classes.shape == valid.shape == (256, m) and classes.dtype == torch.int32
    assert valid.dtype == torch.bool
    assert bool((masks.flatten(2).any(2) == valid).all())  # valid rows non-empty, the rest empty
    row = 0
    for name, lo, hi in layout:
        assert bool((classes[:, row:row + hi] == E.EVENT_TYPES.index(name)).all()), name
        v = valid[:, row:row + hi]
        assert bool((v[:, 1:] <= v[:, :-1]).all()), name  # padding after the valid rows
        counts = v.sum(1)
        assert int(counts.min()) == lo and int(counts.max()) == hi, name
        row += hi
    # the RFI's amplitude, at least rfi_power_min x 1000 mJy, in every event mask
    hit = masks.any(1)
    assert float(wf.abs()[hit].min()) >= 1000.0 * 1000.0
    assert float(wf.abs()[~hit].max()) < 10.0


@pytest.mark.parametrize("mix_name", ["all6", "default"])
def test_generator_statistics_match_jax(mix_name):
    out, jout = _port_samples(mix_name), _jax_samples(mix_name)
    row = 0
    for name, lo, hi in _layout(MIXES[mix_name]):
        sl = slice(row, row + hi)
        v, jv = out["inst_valid"][:, sl].numpy(), jout["inst_valid"][:, sl]
        # counts uniform on [lo, hi]: both means within 4 standard errors
        se = np.sqrt(((hi - lo + 1) ** 2 - 1) / 12 / len(v))
        for counts in (v.sum(1), jv.sum(1)):
            assert abs(counts.mean() - (lo + hi) / 2) <= 4 * se + 1e-12, name
        # the events' areas: the two means within 4 standard errors of
        # their difference
        area = out["inst_masks"][:, sl].sum((2, 3)).numpy()[v]
        jarea = jout["inst_masks"][:, sl].sum((2, 3))[jv]
        se = np.sqrt(area.var() / len(area) + jarea.var() / len(jarea))
        assert abs(area.mean() - jarea.mean()) <= 4 * se, (name, area.mean(), jarea.mean())
        row += hi


def test_fused_steps_equal_sequential_and_history():
    a, b = _trainer(), _trainer()
    ha = a.fit(num_steps=4, fused_steps=4, log_every=4)["history"]
    hb = b.fit(num_steps=4, fused_steps=1, log_every=2)["history"]
    assert a.step == b.step == 4
    for x, y in zip(a.state.params + a.state.mu + a.state.nu,
                    b.state.params + b.state.mu + b.state.nu):
        assert torch.equal(x, y)
    assert ha[-1]["loss"] == hb[-1]["loss"]
    assert [h["step"] for h in hb] == [2, 4]
    assert set(ha[0]) >= {"step", "loss", "cate_loss", "mask_loss", "steps_per_sec"}
    # the JAX recipe's cap at 16 of 16 cells drops nothing; a cap of 1 does
    c = _trainer(max_positive_cells=1)
    hc = c.fit(num_steps=1, log_every=1)["history"]
    assert hc[0]["dropped_mask_cells"] > 0 and "dropped_mask_cells" not in ha[0]


def test_second_fit_continues_the_stream_and_checkpoint_repeats(tmp_path):
    a, b = _trainer(), _trainer()
    a.fit(num_steps=2, fused_steps=2)
    a.save_checkpoint(tmp_path / "ck.pt")
    a.fit(num_steps=2, fused_steps=2)
    b.fit(num_steps=4, fused_steps=2)
    for x, y in zip(a.state.params, b.state.params):
        assert torch.equal(x, y)
    c = _trainer()
    assert c.restore_checkpoint(tmp_path / "ck.pt") == 2
    c.fit(num_steps=2)
    for x, y in zip(a.state.params + a.state.mu, c.state.params + c.state.mu):
        assert torch.equal(x, y)
    s0, s1 = a.sample(5), a.sample(5)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)  # a function of (seed, step)
    assert not torch.equal(a.sample(6)["waterfall"], s0["waterfall"])


def test_snapshots_bit_equal_both_ways(tmp_path):
    tr = _trainer(model=_small_model())
    tr.fit(num_steps=1)
    path = tr.save(tmp_path / "port.npz")
    jtr = JaxInstanceTrainer.load(path, batch_size=2)
    assert jtr.model.features == FEATURES and jtr.patch_size == SIZE
    for a, b in zip(jax.tree.leaves(sololite_to_flax(tr.model)), jax.tree.leaves(jtr.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jpath = jtr.save(tmp_path / "jax.npz")
    back = InstanceTrainer.load(jpath, batch_size=2, device="cpu")
    for a, b in zip(tr.state.params, back.state.params):
        assert torch.equal(a, b)
    assert back.step == 0 and back.model.grid_size == GRID
    images = torch.randn(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(0))
    for x, y in zip(tr.predict(images, score_thresh=0.0), back.predict(images, score_thresh=0.0)):
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_real_fraction_marks_the_replaced_rows_invalid():
    tr = _trainer(batch_size=4)
    real = (np.random.default_rng(1).normal(size=(5, SIZE, SIZE))
            + 1j).astype(np.complex64)
    seen = []
    step = tr._step

    def spy(state, patches, masks, classes, valid):
        seen.append((patches.clone(), valid.clone(), tr.sample(state.step)))
        return step(state, patches, masks, classes, valid)

    tr._step = spy
    tr.fit(num_steps=2, real_patches=real, real_fraction=0.5, fused_steps=2)
    assert len(seen) == 2  # mixing runs one step at a time
    rng = np.random.default_rng(tr.seed)
    for patches, valid, fresh in seen:
        sel = rng.integers(0, len(real), 2)
        np.testing.assert_array_equal(patches[:2].numpy(), real[sel])
        assert not bool(valid[:2].any())
        assert torch.equal(valid[2:], fresh["inst_valid"][2:])
        assert torch.equal(patches[2:], fresh["waterfall"][2:])


def test_evaluate_instance_model_runs_on_its_own_stream():
    tr = _trainer(model=_small_model(), rfi_config=ALL_SIX)
    tr._init()
    q = evaluate_instance_model(tr, num_images=3, batch_size=2, score_thresh=[0.0] * 6)
    assert q["num_images"] == 3 and q["n_gt"] > 0
    assert 0.0 <= q["recall"] <= 1.0 and 0.0 <= q["precision"] <= 1.0
    assert set(q["per_class_recall"]) <= set(range(6))
    assert q["score_thresh"] == [0.0] * 6
    again = evaluate_instance_model(tr, num_images=3, batch_size=2, score_thresh=[0.0] * 6)
    assert again == q


def test_instance_entry_points_want_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InstanceTrainer(model=_small_model(), patch_size=SIZE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_instance_sample_generator(16, 16)
