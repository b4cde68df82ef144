"""Port parity: the coherent RFI simulator against the JAX package, on the
CPU.

``jax.random`` and ``torch.Generator`` streams cannot be matched, so the
render is fed JAX's own draws: ``_jax_draws`` follows ``_rfi_impl``'s key
tree (``random.split`` for split) and hands the port JAX's noise,
modulations, power indices and event parameters.

Tolerances:
- ``phase_grid`` bit-equal to JAX's ``_phase_grid`` run eagerly; within 8
  float32 ulp of the jitted one (XLA rewrites the expression), an ulp
  taken of the sum of the argument's terms' magnitudes, the scale of its
  rounding errors;
- the render against ``_rfi_impl`` run eagerly (``jax.disable_jit``):
  masks equal outside the floor band (pixels where an event's amplitude
  is within 1e-5 relative of ``detect_floor``), complex values within
  1e-5 of |value| (measured 0 without Gibbs ringing, 5.3e-6 with it: the
  ringing sums 17 taps in another order);
- against the jitted ``_rfi_impl`` (the reference as it runs): masks
  equal outside the floor band, and each value within ``16 * ulp(A) *
  S + 1e-5 * |value|``, where ``A`` is the sample's largest phase
  argument and ``S`` the sum of the event amplitudes reaching the pixel:
  a phase error of k ulp of the argument moves a field of amplitude a by
  at most a * k * ulp. Jitted, the phase differs by more than the grid's
  own 8 ulp because XLA also fuses the float32 draws of each event's
  phase parameters (measured 9.7 ulp at 128^2; 0.8% in magnitude where
  fields cancel);
- the port's own stream against JAX's by structure and statistics: the
  mask share of 32 samples within 4 standard errors, event counts and
  ranges exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from rfi_toolbox_tpu.synth import simulator as JS
from rfi_toolbox_tpu_torch.synth import RFISimulator
from rfi_toolbox_tpu_torch.synth.simulator import event_phase, phase_grid

N_SAMPLES = 4  # render parity batch
FRINGES = (30.0, 8.0)


def _phase_draw(key):
    k = random.split(key, 7)
    return {"u": jnp.stack([random.uniform(k[i], ()) for i in range(3, 7)]),
            "signs": jnp.stack([random.bernoulli(k[i]) for i in range(3)])}


@functools.partial(jax.jit, static_argnames=("T", "F"))
def _jax_draws(keys, T, F):
    """The port's draws dict of ``jax.vmap(sim.generate_rfi_device)(keys)``,
    taken along ``_rfi_impl``'s own key tree (simulator.py:151-388)."""
    def one(key):
        k_bl, k_ev = random.split(key)
        keys = random.split(k_ev, 8)
        k = random.split(keys[0], 8)
        noise = jnp.stack([jnp.stack([random.normal(k[2 * i], (T, F)),
                                      random.normal(k[2 * i + 1], (T, F))]) for i in range(4)])

        def bb(k):
            ks = random.split(k, 6)
            start = random.randint(ks[0], (), 0, max(1, F - 1 - 100))
            return {"start": start,
                    "width": random.randint(ks[1], (), 50, jnp.minimum(150, F - 1 - start)),
                    "drifting": random.uniform(ks[2], ()) < 0.3, **_phase_draw(ks[3]),
                    "modulation": random.uniform(ks[4], (T, F), minval=0.5, maxval=2.0),
                    "power": random.randint(ks[5], (T, F), 0, 100)}

        def nb(k):
            ks = random.split(k, 5)
            return {"index": random.randint(ks[0], (), 0, F),
                    "power": random.randint(ks[1], (), 0, 100),
                    "drifting": random.uniform(ks[2], ()) < 0.3, **_phase_draw(ks[3]),
                    "modulation": random.uniform(ks[4], (T,), minval=0.5, maxval=2.0)}

        def tb(k):
            ks = random.split(k, 4)
            return {"index": random.randint(ks[0], (), 0, T),
                    "power": random.randint(ks[1], (), 0, 100), **_phase_draw(ks[2]),
                    "modulation": random.uniform(ks[3], (F,), minval=0.5, maxval=2.0)}

        def lin(k):
            ks = random.split(k, 6)
            return {"start_t": random.randint(ks[0], (), 0, T // 2),
                    "start_f": random.randint(ks[1], (), 0, F // 2),
                    "slope": random.uniform(ks[2], (), minval=-2.0, maxval=2.0),
                    "drifting": random.uniform(ks[3], ()) < 0.3, **_phase_draw(ks[4]),
                    "power": random.randint(ks[5], (T // 2,), 0, 100)}

        def quad(k):
            ks = random.split(k, 5)
            return {"start_t": random.randint(ks[0], (), 0, T // 4),
                    "start_f": random.randint(ks[1], (), 0, F // 4),
                    "direction": random.bernoulli(ks[2]), **_phase_draw(ks[3]),
                    "power": random.randint(ks[4], (T // 4,), 0, 100)}

        kb = random.split(keys[1], 4)
        broadband = jax.vmap(bb)(kb[1:])
        broadband["count"] = random.randint(kb[0], (), 2, 4)
        k_rl, k_lr = random.split(keys[6])
        return {"bl": random.uniform(k_bl, ()), "noise": noise, "broadband": broadband,
                "narrowband": jax.vmap(nb)(random.split(keys[2], int(F * 0.05))),
                "bursts": jax.vmap(tb)(random.split(keys[3], int(T * 0.1))),
                "linear": jax.vmap(lin)(random.split(keys[4], 5)),
                "quadratic": jax.vmap(quad)(random.split(keys[5], 5)),
                "cross": jnp.stack([random.uniform(k_rl, (T, F)), random.uniform(k_lr, (T, F))])}

    return jax.vmap(one)(keys)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.array(tree)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)


def _sims(size, gibbs):
    jsim = JS.RFISimulator(size, size, seed=0)
    jsim.gibbs_ringing = gibbs
    sim = RFISimulator(size, size, device="cpu")
    sim.gibbs_ringing = gibbs
    return jsim, sim


def _amplitudes(d, sim):
    """From the draws: (S, band, A). S (n, 4, T, F): the sum of the event
    amplitudes reaching each pixel of each pol (through the ringing's
    |kernel|); band (n, T, F): pixels where an event's amplitude lies
    within 1e-5 relative of the floor; A (n,): a bound of the sample's
    largest |phase argument|."""
    n, T, F = d["bl"].shape[0], sim.time_bins, sim.freq_bins
    power = torch.as_tensor(sim.power_range)
    bb, nb, tb, lin, quad = (d[k] for k in ("broadband", "narrowband", "bursts",
                                            "linear", "quadratic"))
    b = torch.arange(n)[:, None, None]
    f = torch.arange(F)
    keep = ((f >= bb["start"][..., None]) & (f < (bb["start"] + bb["width"])[..., None])
            & (torch.arange(3) < bb["count"][:, None])[..., None])[:, :, None, :]
    a_bb = bb["modulation"] * power[bb["power"]] * keep
    a_nb = nb["modulation"] * power[nb["power"]][..., None]  # (n, E, T)
    a_tb = tb["modulation"] * power[tb["power"]][..., None]  # (n, E, F)
    at_nb = (b, torch.arange(T), nb["index"][..., None])
    at_tb = (b, tb["index"][..., None], torch.arange(F))
    fields = []
    for at, a in ((at_nb, a_nb), (at_tb, a_tb)):
        fields.append(torch.zeros(n, T, F).index_put_(at, a, accumulate=True))
    s_bb, (s_nb, s_tb) = a_bb.sum(1), fields
    def near(a):
        return (a - sim.detect_floor).abs() <= 1e-5 * sim.detect_floor

    band = (near(a_bb) & keep).any(1)
    for at, a in ((at_nb, a_nb), (at_tb, a_tb)):
        band |= torch.zeros(n, T, F, dtype=torch.int32).index_put_(
            at, near(a).to(torch.int32), accumulate=True) > 0
    if sim.gibbs_ringing:
        k = np.abs(sim._gibbs_kernel)
        h = len(k) // 2

        def conv(x, dim):
            pad = torch.nn.functional.pad(x, (h, h) if dim == -1 else (0, 0, h, h))
            return sum(float(kk) * pad.narrow(dim, j, x.shape[dim]) for j, kk in enumerate(k))

        s_bb, s_nb, s_tb = conv(s_bb, -1), conv(s_nb, -1), conv(s_tb, -2)
    rr = s_bb + s_nb + s_tb
    ll = rr.clone()
    half, quarter = T // 2, T // 4
    f_lin = torch.trunc(lin["start_f"][..., None] + lin["slope"][..., None]
                        * torch.arange(half, dtype=torch.float32)).long() % F
    t_lin = (lin["start_t"][..., None] + torch.arange(half)) % T
    for plane in (rr, ll):
        plane.index_put_((b, t_lin, f_lin), power[lin["power"]], accumulate=True)
    t = torch.arange(quarter)
    f_quad = (quad["start_f"][..., None] + torch.div(
        torch.where(quad["direction"], 1, -1)[..., None] * t ** 2, 100,
        rounding_mode="floor")) % F
    rr.index_put_((b, (quad["start_t"][..., None] + t) % T, f_quad),
                  power[quad["power"]], accumulate=True)
    args = []
    for fam, width, n_times, drifting in (
            (bb, bb["width"], T, bb["drifting"]), (nb, 1, T, nb["drifting"]),
            (tb, F, 1, False), (lin, 1, half, lin["drifting"]), (quad, 1, quarter, True)):
        s0, sdot, r0, phi0 = event_phase(fam["u"], fam["signs"], width, n_times, d["bl"],
                                         drifting, *FRINGES)
        args.append((2 * np.pi * (s0.abs() * F + sdot.abs() * T * F + r0.abs() * T)
                     + phi0.abs()).amax(1))
    # the cross hands add u * RR, u < 1
    return torch.stack([rr, rr, rr, ll], 1), band, torch.stack(args, 1).amax(1)


def _render_case(size, gibbs, seed=3):
    keys = random.split(random.key(seed), N_SAMPLES)
    jsim, sim = _sims(size, gibbs)
    d = _to_torch(_jax_draws(keys, size, size))
    tf, mask = sim.render(d)
    return keys, jsim, sim, d, tf.numpy(), mask.numpy()


@pytest.mark.parametrize("shape", [(1024, 1024), (1, 257), (33, 1)])
def test_phase_grid_bit_equal_to_eager_jax(shape):
    rng = np.random.default_rng(sum(shape))
    t = rng.integers(0, 1024, shape[0]).astype(np.float32)[:, None]
    n = rng.integers(0, 1024, shape[1]).astype(np.float32)[None, :]
    s0, sdot, r0, phi0 = (np.float32(v) for v in rng.uniform(-0.2, 0.2, 4))
    phi0 = np.float32(abs(phi0) * 30)
    want = np.asarray(JS._phase_grid(jnp.asarray(t), jnp.asarray(n), s0, sdot, r0, phi0))
    got = phase_grid(torch.from_numpy(t), torch.from_numpy(n), *(
        torch.tensor(v) for v in (s0, sdot, r0, phi0))).numpy()
    np.testing.assert_array_equal(got, want)


def test_phase_grid_within_ulps_of_jitted_jax():
    rng = np.random.default_rng(0)
    t = np.arange(1024, dtype=np.float32)[:, None]
    n = np.arange(1024, dtype=np.float32)[None, :]
    worst = 0.0
    for _ in range(4):
        s0, sdot, r0 = (np.float32(v) for v in rng.uniform(-0.18, 0.18, 3) * [1, 1e-3, 1])
        phi0 = np.float32(rng.uniform(0, 2 * np.pi))
        want = np.asarray(jax.jit(JS._phase_grid)(t, n, s0, sdot, r0, phi0))
        got = phase_grid(torch.from_numpy(t), torch.from_numpy(n), *(
            torch.tensor(v) for v in (s0, sdot, r0, phi0))).numpy()
        # rounding errors scale with the sum's terms, not its value
        terms = (2 * np.pi * (np.abs(np.float64(s0) + np.float64(sdot) * t) * n
                              + np.abs(np.float64(r0) * t)) + abs(phi0))
        ulps = np.abs(got - want) / np.spacing(terms.astype(np.float32))
        worst = max(worst, float(ulps.max()))
    assert worst <= 8, worst


@pytest.mark.parametrize("width, n_times, drifting", [(73, 128, True), (1, 64, False),
                                                      (128, 1, False), (1, 32, True)])
def test_event_phase_matches_jax(width, n_times, drifting):
    """The render of ``_draw_event_phase`` from its unit draws, within an
    ulp (JAX's uniform fuses its affine map)."""
    keys = random.split(random.key(width + n_times), 16)
    bl = np.float32(0.37)
    want = [np.asarray(v) for v in jax.vmap(lambda k: JS._draw_event_phase(
        k, width, n_times, bl, drifting, *FRINGES))(keys)]
    draws = jax.vmap(_phase_draw)(keys)
    got = event_phase(torch.from_numpy(np.array(draws["u"]))[None],
                      torch.from_numpy(np.array(draws["signs"]))[None], width, n_times,
                      torch.tensor([bl]), drifting, *FRINGES)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), w, rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("size, gibbs", [(64, False), (64, True), (128, False), (128, True)])
def test_render_matches_jitted_rfi_impl(size, gibbs):
    keys, jsim, sim, d, tf, mask = _render_case(size, gibbs)
    want_tf, want_mask = (np.asarray(v) for v in jax.vmap(jsim.generate_rfi_device)(keys))
    s, band, a = _amplitudes(d, sim)
    assert not (mask != want_mask)[~band.numpy()].any()
    assert 0.2 < mask.mean() < 0.95
    ulp = np.spacing(a.numpy().astype(np.float32))[:, None, None, None]
    bound = 16 * ulp * s.numpy() + 1e-5 * np.abs(want_tf)
    err = np.abs(tf - want_tf)
    assert (err <= bound).all(), float((err / bound).max())


def test_render_matches_eager_rfi_impl():
    """Eagerly, the reference's arithmetic is the port's, op for op."""
    keys, jsim, sim, d, tf, mask = _render_case(64, True, seed=5)
    with jax.disable_jit():
        want_tf, want_mask = (np.asarray(v) for v in jax.vmap(jsim.generate_rfi_device)(keys))
    _, band, _ = _amplitudes(d, sim)
    assert not (mask != want_mask)[~band.numpy()].any()
    np.testing.assert_array_less(np.abs(tf - want_tf), 1e-5 * np.abs(want_tf) + 1e-30)


def test_stream_statistics_match_jax():
    """The port's own stream against JAX's at 128^2, 32 samples each."""
    size, n = 128, 32
    sim = RFISimulator(size, size, device="cpu")
    g = torch.Generator().manual_seed(11)
    d = sim.draw(n, g)
    tf, mask = sim.render(d)
    jsim = JS.RFISimulator(size, size, seed=0)
    keys = random.split(random.key(11), n)
    jmask = np.concatenate([np.asarray(jax.vmap(jsim.generate_rfi_device)(keys[i:i + 4])[1])
                            for i in range(0, n, 4)])
    share, jshare = mask.float().mean((1, 2)).numpy(), jmask.mean((1, 2))
    se = np.sqrt(share.var() / n + jshare.var() / n)
    assert abs(share.mean() - jshare.mean()) <= 4 * se, (share.mean(), jshare.mean(), se)
    # structure: counts and ranges as the reference draws them
    bb = d["broadband"]
    assert set(bb["count"].tolist()) == {2, 3}
    assert int(bb["start"].min()) >= 0 and int(bb["start"].max()) < size - 101
    end = torch.clamp(size - 1 - bb["start"], max=150)
    assert bool(((bb["width"] >= 50) & (bb["width"] < end)).all())
    assert d["narrowband"]["index"].shape == (n, int(size * 0.05))
    assert d["bursts"]["index"].shape == (n, int(size * 0.1))
    for fam in ("linear", "quadratic"):
        assert d[fam]["start_t"].shape == (n, 5)
    assert int(d["linear"]["start_t"].max()) < size // 2
    assert int(d["quadratic"]["start_f"].max()) < size // 4
    assert 0 <= float(d["bl"].min()) < 0.2 and 0.8 < float(d["bl"].max()) < 1
    drift = torch.cat([bb["drifting"].flatten(), d["narrowband"]["drifting"].flatten(),
                       d["linear"]["drifting"].flatten()]).float().mean()
    assert abs(float(drift) - 0.3) < 0.05
    assert tf.shape == (n, 4, size, size) and tf.dtype == torch.complex64
    assert mask.dtype == torch.bool
    # RL, LR: noise plus u * RR with u ~ U[0, 1)
    ll_noise = d["noise"][:, 3, 0]
    assert abs(float(ll_noise.std()) - 1) < 0.01


def test_generate_rfi_host_api():
    jsim = JS.RFISimulator(64, 64, seed=0)
    jtf, jmask = jsim.generate_rfi(baseline_frac=0.25)
    sim = RFISimulator(64, 64, seed=0, device="cpu")
    tf, mask = sim.generate_rfi(baseline_frac=0.25)
    assert sim.baseline_frac == jsim.baseline_frac == 0.25
    assert set(tf) == set(jtf) == {"RR", "RL", "LR", "LL"}
    for pol in tf:
        assert isinstance(tf[pol], np.ndarray) and tf[pol].dtype == jtf[pol].dtype
        assert tf[pol].shape == jtf[pol].shape
    assert mask.dtype == jmask.dtype and mask.shape == jmask.shape and mask.any()
    assert sim.tf_plane is tf and sim.mask is mask
    first = tf["RR"].copy()
    assert not np.array_equal(sim.generate_rfi()[0]["RR"], first)  # the generator advances
    assert 0 <= sim.baseline_frac < 1
    clean, cmask = sim.generate_clean_data()
    assert not cmask.any() and abs(float(np.std(clean["LR"].real)) - 1) < 0.05


def test_render_draws_nothing():
    """The render draws nothing: the same draws render alike twice."""
    sim = RFISimulator(64, 64, device="cpu")
    sim.gibbs_ringing = True
    d = sim.draw(2, torch.Generator().manual_seed(0))
    a, b = sim.render(d), sim.render(d)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_simulator_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RFISimulator(64, 64)
    assert RFISimulator(64, 64, device="cpu").device == torch.device("cpu")
