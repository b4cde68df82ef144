"""Coherent-phase time-frequency RFI simulator on the card.

Counterpart of ``rfi_toolbox_tpu/synth/simulator.py`` (``RFISimulator``).
Each RFI event carries a coherent geometric phase

    phi(t, n) = 2*pi * [ (s0 + sdot*t) * n + r0 * t ] + phi0

with fringe rates scaled by the baseline length, drift probability 0.3,
and full-injection ground truth: every injected pixel whose amplitude is
above ``detect_floor`` is RFI. Optional Gibbs ringing (a sinc
channelizer response, off by default) spreads each family's summed field
along its axis after the mask is taken. Planes are (time, freq), the
transpose of the generator's (channels, times).

Where the JAX package ``vmap``s one sample over keys, the port draws a
whole batch from one ``torch.Generator``, and it keeps each draw apart
from its render:

- :meth:`RFISimulator.draw` takes every random number of a batch (the
  noise planes, the event parameters, modulations and power indices);
- :meth:`RFISimulator.render` turns them into the four polarisation
  planes and the mask, with no randomness of its own.

The streams of ``jax.random`` and ``torch.Generator`` cannot be matched,
so a test hands the render the numbers that JAX's own key tree draws.
The phase is computed in float32 one eager operation at a time in the
reference's order (:func:`phase_grid`), so it is bit-equal to the JAX
expression run eagerly and the same on the card and the CPU. Events that
share a pixel are summed with ``index_put_(accumulate=True)``, in
another order than XLA's scatter.
"""

import math

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["RFISimulator", "phase_grid", "event_phase", "POLS"]

POLS = ("RR", "RL", "LR", "LL")
MAX_BROADBAND = 3  # broadband blocks a sample: 2 or 3
N_SWEEPS = 5  # linear sweeps (RR and LL) and quadratic sweeps (RR) a sample


def phase_grid(t, n, s0, sdot, r0, phi0):
    """phi(t, n) in float32, each operation rounded on its own in the
    reference's order (simulator.py:38-40). Inputs broadcast."""
    return 2.0 * math.pi * ((s0 + sdot * t) * n + r0 * t) + phi0


def _scaled(u, lo, hi):
    """``jax.random.uniform``'s map of a unit draw ``u`` onto [lo, hi)
    for a float ``lo``: ``max(lo, u * (hi - lo) + lo)`` in float32."""
    return (u * (hi - lo) + lo).clamp_min(lo)


def event_phase(u, signs, width, n_times, bl, drifting, max_time_fringes,
                max_freq_fringes):
    """(s0, sdot, r0, phi0) of events from their draws (simulator.py:43-63),
    each of the draws' leading shape (n, E).

    Args:
        u: (n, E, 4) unit uniforms: time fringes, frequency fringes, phi0
            and the drift's end slope.
        signs: (n, E, 3) bool, True for +1: r0's, s0's and the end slope's.
        width, n_times: the event's extent in channels and times, ints or
            (n, E) integer tensors, taken as at least 1.
        bl: (n,) float32 baseline fraction of each sample.
        drifting: (n, E) bool, or a python bool for all events.
    """
    bl = bl[:, None]
    w = torch.as_tensor(width, device=u.device).clamp_min(1).to(torch.float32)
    nt = torch.as_tensor(n_times, device=u.device).clamp_min(1).to(torch.float32)
    sign = torch.where(signs, 1.0, -1.0)
    n_ft = _scaled(u[..., 0], 0.5, 1.0 + bl * max_time_fringes)
    r0 = (n_ft / nt) * sign[..., 0]
    n_ff = _scaled(u[..., 1], 0.5, 1.0 + bl * max_freq_fringes)
    s0 = (n_ff / w) * sign[..., 1]
    phi0 = _scaled(u[..., 2], 0.0, 2.0 * math.pi)
    s_end = (_scaled(u[..., 3], 0.5, 1.0 + bl * max_freq_fringes) / w) * sign[..., 2]
    sdot = torch.where(torch.as_tensor(drifting, device=u.device), (s_end - s0) / nt, 0.0)
    return s0, sdot, r0, phi0


def _scatter_add_(field, index, values):
    """field[index] += values for complex64 tensors, duplicates summed."""
    torch.view_as_real(field).index_put_(index, torch.view_as_real(values),
                                         accumulate=True)


def _conv_along(x, kernel, dim):
    """'same' 1-D convolution of a complex (n, T, F) field with an odd,
    symmetric kernel along ``dim`` (-1 freq, -2 time): a float32 sum of
    the kernel's shifted products, each a separate operation, so that the
    card and the CPU compute it alike (simulator.py:188-202)."""
    half = len(kernel) // 2
    xr = torch.view_as_real(x)  # (n, T, F, 2)
    pad = (0, 0, half, half) if dim == -1 else (0, 0, 0, 0, half, half)
    xp = torch.nn.functional.pad(xr, pad)
    length = x.shape[dim]
    out = torch.zeros_like(xr)
    for j, k in enumerate(kernel.tolist()):
        out = out + k * xp.narrow(dim - 1, j, length)
    return torch.view_as_complex(out.contiguous())


class RFISimulator:
    """Time-frequency RFI simulator with coherent phase, on the card.

    >>> sim = RFISimulator(time_bins=1024, freq_bins=1024, seed=0)
    >>> tf, mask = sim.generate_rfi_device(8, torch.Generator("cuda").manual_seed(1))
    >>> tf.shape, mask.shape   # (8, 4, 1024, 1024) complex64, (8, 1024, 1024) bool

    Args:
        time_bins, freq_bins: plane shape (T, F), 8 and more each; the
            broadband blocks are 50 to 149 channels wide.
        seed: seeds the simulator's own generator, which the host calls
            (:meth:`generate_rfi`, :meth:`generate_clean_data`) advance.
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.

    Attributes are the reference's: ``power_range`` (100 float32 powers,
    1e-6 to 1e4), ``detect_floor`` 1.0, ``drift_prob`` 0.3, the fringe
    maxima ``max_time_fringes`` 30 and ``max_freq_fringes`` 8,
    ``gibbs_ringing`` (False) with its sinc ``_gibbs_kernel``,
    ``baseline_frac``, and the last host planes ``tf_plane`` (pol -> (T,
    F) complex64 numpy) and ``mask``.
    """

    def __init__(self, time_bins=1024, freq_bins=1024, seed=0, device=None):
        self.device = resolve_device(device)
        self.time_bins = int(time_bins)
        self.freq_bins = int(freq_bins)
        self.power_range = np.logspace(-6, 4, num=100).astype(np.float32)
        self.detect_floor = 1.0
        self.drift_prob = 0.3
        self.max_time_fringes = 30.0
        self.max_freq_fringes = 8.0
        self.gibbs_ringing = False
        self._gibbs_kernel = self._make_gibbs_kernel(n_side=8, stretch=2.0)
        self.baseline_frac = 0.5
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.tf_plane = {
            pol: np.zeros((self.time_bins, self.freq_bins), dtype=np.complex64)
            for pol in POLS
        }
        self.mask = np.zeros((self.time_bins, self.freq_bins), dtype=bool)

    @staticmethod
    def _make_gibbs_kernel(n_side=8, stretch=2.0):
        x = np.arange(-n_side, n_side + 1) / float(stretch)
        k = np.sinc(x)
        return (k / k.sum()).astype(np.float32)

    def _generator(self, generator):
        g = self.generator if generator is None else generator
        if g.device.type != self.device.type:
            raise ValueError(f"generator on {g.device}, simulator on {self.device}")
        return g

    # ------------------------------------------------------------- draws
    def draw(self, n, generator=None, baseline_frac=None):
        """Every random number of ``n`` samples, as a dict of tensors on
        the simulator's device (the render's only input):

        - ``bl`` (n,) float32 baseline fraction (uniform, or
          ``baseline_frac``); ``noise`` (n, 4, 2, T, F) standard normals
          (pol, re/im); ``cross`` (n, 2, T, F) unit uniforms (RL, LR);
        - ``broadband``: ``count`` (n,) in {2, 3}, ``start`` and ``width``
          (n, 3), ``drifting`` (n, 3), ``modulation`` (n, 3, T, F) in
          [0.5, 2), ``power`` (n, 3, T, F) indices into ``power_range``;
        - ``narrowband`` (int(F * 0.05) events): ``index`` (channel),
          ``power``, ``drifting`` (n, E), ``modulation`` (n, E, T);
        - ``bursts`` (int(T * 0.1) events, never drifting): ``index``
          (time), ``power`` (n, E), ``modulation`` (n, E, F);
        - ``linear``: ``start_t``, ``start_f``, ``slope`` in [-2, 2),
          ``drifting`` (n, 5), ``power`` (n, 5, T // 2);
        - ``quadratic`` (always drifting): ``start_t``, ``start_f``,
          ``direction`` (n, 5) bool (True for +1), ``power`` (n, 5, T // 4);
        - each family also ``u`` (..., 4) and ``signs`` (..., 3), the
          draws of its events' phases (:func:`event_phase`).
        """
        g = self._generator(generator)
        n, T, F = int(n), self.time_bins, self.freq_bins
        n_pow = len(self.power_range)

        def rand(*shape):
            return torch.rand(shape, generator=g, device=g.device)

        def randint(lo, hi, *shape):
            return torch.randint(int(lo), int(hi), shape, generator=g, device=g.device)

        def phase(*shape):
            return {"u": rand(*shape, 4), "signs": rand(*shape, 3) < 0.5}

        if baseline_frac is None:
            bl = rand(n)
        else:
            bl = torch.full((n,), float(baseline_frac), device=g.device)
        start = randint(0, max(1, F - 1 - 100), n, MAX_BROADBAND)
        # width ~ randint(50, min(150, F - 1 - start)), 50 for an empty range
        span = (torch.clamp(F - 1 - start, max=150) - 50).clamp_min(1)
        u = torch.rand((n, MAX_BROADBAND), generator=g, device=g.device,
                       dtype=torch.float64)
        width = 50 + torch.minimum((u * span).long(), span - 1)
        broadband = {"count": randint(2, MAX_BROADBAND + 1, n), "start": start,
                     "width": width,
                     "drifting": rand(n, MAX_BROADBAND) < self.drift_prob,
                     **phase(n, MAX_BROADBAND),
                     "modulation": _scaled(rand(n, MAX_BROADBAND, T, F), 0.5, 2.0),
                     "power": randint(0, n_pow, n, MAX_BROADBAND, T, F)}
        e_nb, e_tb = int(F * 0.05), int(T * 0.1)
        narrowband = {"index": randint(0, F, n, e_nb), "power": randint(0, n_pow, n, e_nb),
                      "drifting": rand(n, e_nb) < self.drift_prob, **phase(n, e_nb),
                      "modulation": _scaled(rand(n, e_nb, T), 0.5, 2.0)}
        bursts = {"index": randint(0, T, n, e_tb), "power": randint(0, n_pow, n, e_tb),
                  **phase(n, e_tb), "modulation": _scaled(rand(n, e_tb, F), 0.5, 2.0)}
        linear = {"start_t": randint(0, T // 2, n, N_SWEEPS),
                  "start_f": randint(0, F // 2, n, N_SWEEPS),
                  "slope": _scaled(rand(n, N_SWEEPS), -2.0, 2.0),
                  "drifting": rand(n, N_SWEEPS) < self.drift_prob, **phase(n, N_SWEEPS),
                  "power": randint(0, n_pow, n, N_SWEEPS, T // 2)}
        quadratic = {"start_t": randint(0, T // 4, n, N_SWEEPS),
                     "start_f": randint(0, F // 4, n, N_SWEEPS),
                     "direction": rand(n, N_SWEEPS) < 0.5, **phase(n, N_SWEEPS),
                     "power": randint(0, n_pow, n, N_SWEEPS, T // 4)}
        return {"bl": bl, "noise": torch.randn((n, 4, 2, T, F), generator=g,
                                               device=g.device),
                "broadband": broadband, "narrowband": narrowband, "bursts": bursts,
                "linear": linear, "quadratic": quadratic, "cross": rand(n, 2, T, F)}

    # ------------------------------------------------------------ render
    def _phase(self, fam, width, n_times, bl, drifting):
        return event_phase(fam["u"], fam["signs"], width, n_times, bl, drifting,
                           self.max_time_fringes, self.max_freq_fringes)

    def render(self, draws):
        """The planes and mask of :meth:`draw`'s numbers
        (simulator.py:205-388): ``(tf (n, 4, T, F) complex64, mask (n, T,
        F) bool)``, pols in ``POLS`` order, on the draws' device."""
        d = draws
        bl, noise = d["bl"], d["noise"]
        dev = bl.device
        n, T, F = bl.shape[0], self.time_bins, self.freq_bins
        power = torch.as_tensor(self.power_range, device=dev)
        floor = self.detect_floor
        rr, rl, lr, ll = (torch.complex(noise[:, p, 0], noise[:, p, 1]) for p in range(4))
        mask = torch.zeros((n, T, F), dtype=torch.bool, device=dev)
        hits = torch.zeros((n, T, F), dtype=torch.int32, device=dev)
        b = torch.arange(n, device=dev)[:, None, None]
        t_col = torch.arange(T, dtype=torch.float32, device=dev)[:, None]
        f_row = torch.arange(F, dtype=torch.float32, device=dev)[None, :]

        # broadband blocks: 2-3 frequency blocks over all times
        bb = d["broadband"]
        s0, sdot, r0, phi0 = self._phase(bb, bb["width"], T, bl, bb["drifting"])
        bb_field = torch.zeros((n, T, F), dtype=torch.complex64, device=dev)
        for e in range(MAX_BROADBAND):
            lo = bb["start"][:, e, None, None]
            in_range = (f_row >= lo) & (f_row < lo + bb["width"][:, e, None, None])
            keep = in_range & (e < bb["count"])[:, None, None]
            amp = bb["modulation"][:, e] * power[bb["power"][:, e]]
            grid = phase_grid(t_col, f_row, *(p[:, e, None, None] for p in (s0, sdot, r0, phi0)))
            field = torch.where(keep, torch.polar(amp, grid), 0)
            mask |= (field.abs() > floor) & keep
            bb_field = bb_field + field

        # narrowband: single channels over all times
        nb = d["narrowband"]
        nb_field = torch.zeros((n, T, F), dtype=torch.complex64, device=dev)
        if nb["index"].shape[1]:
            s0, sdot, r0, phi0 = self._phase(nb, 1, T, bl, nb["drifting"])
            t = torch.arange(T, dtype=torch.float32, device=dev)
            idx = nb["index"][..., None]  # (n, E, 1)
            amp = nb["modulation"] * power[nb["power"]][..., None]
            field = torch.polar(amp, phase_grid(t, idx.to(torch.float32), *(
                p[..., None] for p in (s0, sdot, r0, phi0))))  # (n, E, T)
            at = (b, torch.arange(T, device=dev), idx)
            _scatter_add_(nb_field, at, field)
            hits.index_put_(at, (field.abs() > floor).to(torch.int32), accumulate=True)

        # time bursts: single times over all channels, never drifting
        tb = d["bursts"]
        tb_field = torch.zeros((n, T, F), dtype=torch.complex64, device=dev)
        if tb["index"].shape[1]:
            s0, sdot, r0, phi0 = self._phase(tb, F, 1, bl, False)
            f = torch.arange(F, dtype=torch.float32, device=dev)
            idx = tb["index"][..., None]
            amp = tb["modulation"] * power[tb["power"]][..., None]
            field = torch.polar(amp, phase_grid(idx.to(torch.float32), f, *(
                p[..., None] for p in (s0, sdot, r0, phi0))))  # (n, E, F)
            at = (b, idx, torch.arange(F, device=dev))
            _scatter_add_(tb_field, at, field)
            hits.index_put_(at, (field.abs() > floor).to(torch.int32), accumulate=True)

        # Gibbs ringing spreads each family along its axis; the mask above
        # is the un-spread core
        if self.gibbs_ringing:
            bb_field = _conv_along(bb_field, self._gibbs_kernel, -1)
            nb_field = _conv_along(nb_field, self._gibbs_kernel, -1)
            tb_field = _conv_along(tb_field, self._gibbs_kernel, -2)
        spread = bb_field + nb_field + tb_field
        rr = rr + spread
        ll = ll + spread

        # linear sweeps on RR and LL: one point a time step over T // 2
        lin = d["linear"]
        half = T // 2
        s0, sdot, r0, phi0 = self._phase(lin, 1, half, bl, lin["drifting"])
        i = torch.arange(half, dtype=torch.float32, device=dev)
        # python int() truncates toward zero (simulator.py:334-335)
        f_idx = torch.trunc(lin["start_f"][..., None] + lin["slope"][..., None] * i).long() % F
        t_idx = (lin["start_t"][..., None] + torch.arange(half, device=dev)) % T
        amp = power[lin["power"]]
        val = torch.polar(amp, phase_grid(t_idx.to(torch.float32), f_idx.to(torch.float32), *(
            p[..., None] for p in (s0, sdot, r0, phi0))))
        at = (b, t_idx, f_idx)
        _scatter_add_(rr, at, val)
        _scatter_add_(ll, at, val)
        hits.index_put_(at, (amp > floor).to(torch.int32), accumulate=True)

        # quadratic sweeps on RR: over T // 4, always drifting
        quad = d["quadratic"]
        quarter = T // 4
        s0, sdot, r0, phi0 = self._phase(quad, 1, quarter, bl, True)
        t = torch.arange(quarter, device=dev)
        direction = torch.where(quad["direction"], 1, -1)[..., None]
        # floor division after the sign (simulator.py:365-366)
        f_idx = (quad["start_f"][..., None]
                 + torch.div(direction * t ** 2, 100, rounding_mode="floor")) % F
        t_idx = (quad["start_t"][..., None] + t) % T
        amp = power[quad["power"]]
        val = torch.polar(amp, phase_grid(t_idx.to(torch.float32), f_idx.to(torch.float32), *(
            p[..., None] for p in (s0, sdot, r0, phi0))))
        at = (b, t_idx, f_idx)
        _scatter_add_(rr, at, val)
        hits.index_put_(at, (amp > floor).to(torch.int32), accumulate=True)
        mask |= hits > 0

        # the cross hands inherit RR's coherent structure
        u_rl, u_lr = d["cross"][:, 0], d["cross"][:, 1]
        rl = rl + torch.complex(u_rl * rr.real, u_rl * rr.imag)
        lr = lr + torch.complex(u_lr * rr.real, u_lr * rr.imag)
        return torch.stack([rr, rl, lr, ll], dim=1), mask

    # ------------------------------------------------------------ device
    def generate_rfi_device(self, n, generator=None, baseline_frac=None):
        """``n`` samples on the device: ``(tf (n, 4, T, F) complex64,
        mask (n, T, F) bool)``, pols in ``POLS`` order. ``generator``: a
        ``torch.Generator`` on the simulator's device (default: the
        simulator's own); ``baseline_frac`` None draws one a sample."""
        return self.render(self.draw(n, generator, baseline_frac))

    # -------------------------------------------------------------- host
    def _to_host(self, tf, mask):
        tf = tf[0].cpu().numpy()
        self.tf_plane = {pol: tf[i] for i, pol in enumerate(POLS)}
        self.mask = mask[0].cpu().numpy()
        return self.tf_plane, self.mask

    def generate_clean_data(self, generator=None):
        """RFI-free unit complex Gaussian planes (simulator.py:105-113):
        ``(tf_plane, mask)`` on the host."""
        g = self._generator(generator)
        noise = torch.randn((1, 4, 2, self.time_bins, self.freq_bins),
                            generator=g, device=g.device)
        tf = torch.complex(noise[:, :, 0], noise[:, :, 1])
        mask = torch.zeros((1, self.time_bins, self.freq_bins), dtype=torch.bool)
        return self._to_host(tf, mask)

    def generate_rfi(self, baseline_frac=None, generator=None):
        """One RFI-contaminated sample and its full-truth mask on the host
        (simulator.py:116-149): ``(tf_plane, mask)``. ``baseline_frac`` in
        [0, 1] sets the fringe rates; None draws one."""
        d = self.draw(1, generator, baseline_frac)
        self.baseline_frac = float(d["bl"][0])
        return self._to_host(*self.render(d))
