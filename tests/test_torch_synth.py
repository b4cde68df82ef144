"""Port parity: the synthetic waterfall generator against the JAX
package, on the CPU.

``jax.random`` and ``torch.Generator`` streams cannot be matched, so:

- profiles rebuilt from the parameters that the JAX functions return
  must equal the JAX profiles bit for bit (the frequency sweep and the
  non-bursty separable events); ``generate_bandpass`` is bit-equal;
- the generator is checked by structure and statistics: the mask is the
  exact support of the injected signal, counts, bandwidths and burst
  widths stay in their configured ranges, amplitudes lie in
  [1000, 10000] x 1000 (mJy) x noise, the noise has its configured level,
  and the flagged fraction is that of the JAX generator within a stated
  margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.synth import events as JE
from rfi_toolbox_tpu.synth import sample as JS
from rfi_toolbox_tpu_torch.synth import events as E
from rfi_toolbox_tpu_torch.synth import generate_bandpass, make_sample_generator

# the headline benchmark's event mix
RFI_CONFIG = {
    "narrowband_persistent": {"count": 20},
    "broadband_persistent": {"count": 5},
    "narrowband_bursty": {"count": 20},
    "broadband_bursty": {"count": 5},
    "frequency_sweep": {"count": 1},
}


def _params(p, e=None):
    """JAX parameter tree -> tensors (event e of each leaf, if given)."""
    return {k: torch.from_numpy(np.array(v if e is None else v[e]))
            for k, v in p.items()}


@pytest.mark.parametrize("nc, order", [(100, 8), (64, 3), (1024, 8), (9, 2)])
def test_bandpass_bit_equal(nc, order):
    got = generate_bandpass(nc, order, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(JS.generate_bandpass(nc, order)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sweep_mask_rebuilt_from_jax_params(seed):
    nc, nt, max_events = 96, 80, 3
    amps = jnp.asarray([1e6, 2e6, 3e6], jnp.float32)
    signal, mask, params = JE.frequency_sweep_accumulate(
        jax.random.key(seed), nc, nt, max_events, 2, amps)
    got = torch.zeros(nc, nt, dtype=torch.bool)
    got_signal = torch.zeros(nc, nt)
    for e in range(2):  # count 2: the third event is invalid
        m = E.sweep_profile(_params(params, e), nc, nt)
        got |= m
        got_signal += float(amps[e]) * m
    np.testing.assert_array_equal(got.numpy(), np.asarray(mask))
    np.testing.assert_allclose(got_signal.numpy(), np.asarray(signal), rtol=1e-6)


@pytest.mark.parametrize("name", ["narrowband_persistent", "broadband_persistent",
                                  "narrowband_intermittent"])
def test_separable_profiles_rebuilt_from_jax_params(name):
    nc, nt = 120, 150
    keys = jax.random.split(jax.random.key(4), 16)
    f, t, p = jax.vmap(lambda k: JE.SEPARABLE_TYPES[name](k, nc, nt))(keys)
    got_f, got_t = E.SEPARABLE_TYPES[name][1](_params(p), nc, nt)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(f))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(t))


def test_event_draws_in_range():
    g = torch.Generator().manual_seed(0)
    nc, nt, shape = 200, 300, (64, 5)
    p = E.draw_narrowband_intermittent(g, shape, nc, nt)
    assert int(p["center_freq"].min()) >= 20 and int(p["center_freq"].max()) < 180
    assert 2 <= int(p["bandwidth"].min()) and int(p["bandwidth"].max()) < 15
    assert 20 <= int(p["period"].min()) and int(p["period"].max()) < 200
    assert 0.1 <= float(p["duty_cycle"].min()) and float(p["duty_cycle"].max()) < 0.5
    for n_lo, n_hi, w_lo, w_hi in [(3, 15, 2, 20), (2, 10, 1, 5)]:
        b = E.draw_bursts(g, shape, nt, n_lo, n_hi, w_lo, w_hi)
        assert n_lo <= int(b["num_bursts"].min()) and int(b["num_bursts"].max()) < n_hi
        assert w_lo <= int(b["burst_widths"].min()) and int(b["burst_widths"].max()) < w_hi
        times = b["burst_times"].reshape(-1, n_hi - 1)
        assert all(len(set(row.tolist())) == n_hi - 1 for row in times)  # distinct
        t = E.bursty_time_profile(b, nt)
        # each burst covers its window [t - w//2, t + w//2) and nothing else
        first = b["burst_times"][0, 0, 0] - b["burst_widths"][0, 0, 0] // 2
        assert float(t[0, 0, max(int(first), 0)]) == 1.0
    s = E.draw_sweep(g, shape, nc, nt)
    assert 20 <= int(s["start_freq"].min()) and int(s["start_freq"].max()) < 100
    assert 100 <= int(s["end_freq"].min()) and int(s["end_freq"].max()) < 180
    assert set(s["sweep_order"].unique().tolist()) == {1, 2}


def _sample(batch, nc=128, nt=128, seed=0, **kwargs):
    fn = make_sample_generator(nc, nt, rfi_config=RFI_CONFIG, device="cpu", **kwargs)
    return fn(batch, torch.Generator().manual_seed(seed))


def test_generator_shapes_and_mask_is_signal_support():
    wf, mask, params = _sample(4, num_polarizations=3)
    assert wf.shape == (4, 3, 128, 128) and wf.dtype == torch.complex64
    assert mask.shape == wf.shape and mask.dtype == torch.bool
    amp = wf.abs()
    # noise |x| ~ 1 +- 0.1; the weakest event is 1000 x 1000 mJy
    np.testing.assert_array_equal((amp[:, 0] > 1e3).numpy(), mask[:, 0].numpy())
    assert float(amp[:, 0][mask[:, 0]].min()) >= 1e6 * 0.999
    assert torch.equal(mask[:, 1], mask[:, 0])  # correlated polarisation
    assert not bool(mask[:, 2].any())           # noise-only polarisation
    assert float(amp[:, 2].max()) < 2.0
    for name, (lo, hi) in {"narrowband_persistent": (1, 10),
                           "narrowband_bursty": (2, 20)}.items():
        bw = params[name]["bandwidth"]
        assert lo <= int(bw.min()) and int(bw.max()) < hi
        assert params[name]["bandwidth"].shape == (4, RFI_CONFIG[name]["count"])


def test_generator_amplitudes_and_noise():
    wf, mask, params = _sample(4, noise_level=[0.5, 2.0],
                               rfi_power_min=[1000.0, 2000.0],
                               rfi_power_max=[5000.0, 10000.0])
    for p in params.values():
        a = p["amplitude_mjy"]
        assert float(a.min()) >= 1000.0 * 1000.0 * 0.9999
        assert float(a.max()) <= 10000.0 * 1000.0 * 1.0001
    amp = wf.abs()[:, 0]
    for b in range(4):
        clean = amp[b][~mask[b, 0]]
        level = float(clean.mean())
        assert 0.5 * 0.99 <= level <= 2.0 * 1.01
        assert abs(float(clean.std()) / level - 0.1) < 0.01
        rfi = amp[b][mask[b, 0]]
        assert float(rfi.min()) >= 1000.0 * 1000.0 * 0.999 - 1.5 * level


def test_generator_counts_in_range():
    config = {"narrowband_persistent": {"count": [2, 6]},
              "broadband_bursty": {"count": [0, 3]},
              "frequency_sweep": {"count": [1, 2]}}
    fn = make_sample_generator(96, 96, rfi_config=config, device="cpu")
    _, _, params = fn(32, torch.Generator().manual_seed(3))
    for name, cfg in config.items():
        lo, hi = cfg["count"]
        c = params[name]["_count"]
        assert lo <= int(c.min()) and int(c.max()) <= hi
        assert int(c.min()) < int(c.max())  # the count is drawn


def test_generator_bandpass_scales_baseline():
    fn = make_sample_generator(100, 64, rfi_config={"narrowband_persistent": {"count": 2}},
                               enable_bandpass=True, bandpass_order=2, device="cpu")
    wf, mask, _ = fn(2, torch.Generator().manual_seed(1))
    amp = wf.abs()[:, 0]
    bp = generate_bandpass(100, 2, device="cpu")
    clean = torch.where(mask[:, 0], torch.nan, amp).nanmean(dim=(0, 2))
    ok = (bp > 0.2) & torch.isfinite(clean)  # a few channels are all RFI
    assert int(ok.sum()) > 50
    assert float((clean[ok] / bp[ok] - 1).abs().max()) < 0.05


def test_flagged_fraction_matches_jax_generator():
    """Same laws, different streams: the mean flagged fraction over 16
    waterfalls of 256 x 256 agrees within 15% (its spread across such
    batches is a few percent)."""
    nc = nt = 256
    _, mask, _ = _sample(16, nc=nc, nt=nt, seed=5)
    jfn = JS.make_sample_generator(nc, nt, rfi_config=RFI_CONFIG)
    _, jmask, _ = jax.vmap(jfn)(jax.random.split(jax.random.key(5), 16))
    got, want = float(mask.float().mean()), float(np.asarray(jmask).mean())
    assert abs(got / want - 1) < 0.15, (got, want)


def test_generator_wants_a_generator_on_its_device():
    fn = make_sample_generator(32, 32, device="cpu")
    wf, mask, _ = fn(1, torch.Generator().manual_seed(0))
    assert wf.shape == (1, 1, 32, 32)
    again, _, _ = fn(1, torch.Generator().manual_seed(0))
    assert torch.equal(wf, again)
