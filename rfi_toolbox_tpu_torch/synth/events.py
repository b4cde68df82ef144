"""RFI event samplers on tensors.

Counterpart of ``rfi_toolbox_tpu/synth/events.py``. Each separable event
is a pair of profiles, a frequency indicator (..., nc) and a time
indicator (..., nt), so that a stack of E events reduces to two batched
matrix products (:mod:`.sample`):

    signal = (F * amp).T @ T        mask = (F.T @ T) > 0

The frequency sweep is not separable; :func:`frequency_sweep_accumulate`
adds its masks one event at a time.

Each event type has a draw, ``draw_<type>(generator, shape, nc, nt)``,
which returns its parameters as tensors of leading shape ``shape`` on the
generator's device, apart from the function that builds its profiles
from them, ``<type>_profile(params, nc, nt)``. The parameter laws are
the reference's; the random streams (``torch.Generator`` here,
``jax.random`` there) cannot be matched, so a test rebuilds profiles
from the reference's parameters.
"""

import torch

__all__ = [
    "draw_narrowband_persistent",
    "narrowband_persistent_profile",
    "draw_broadband_persistent",
    "broadband_persistent_profile",
    "draw_narrowband_intermittent",
    "narrowband_intermittent_profile",
    "draw_narrowband_bursty",
    "narrowband_bursty_profile",
    "draw_broadband_bursty",
    "broadband_bursty_profile",
    "draw_bursts",
    "bursty_time_profile",
    "draw_sweep",
    "sweep_profile",
    "frequency_sweep_accumulate",
    "SEPARABLE_TYPES",
    "EVENT_TYPES",
    "MAX_SUBBURSTS",
]

# Upper bounds of the reference's randint draws (exclusive high - 1).
MAX_SUBBURSTS = {"narrowband_bursty": 14, "broadband_bursty": 9}


def _randint(g, lo, hi, shape):
    return torch.randint(int(lo), int(hi), tuple(shape), generator=g,
                         device=g.device)


def _uniform(g, lo, hi, shape):
    u = torch.rand(tuple(shape), generator=g, device=g.device)
    return lo + (hi - lo) * u


def _window(n, lo, hi):
    """(..., n) float32 indicator of [lo, hi) for integer tensors lo, hi."""
    idx = torch.arange(n, device=lo.device)
    return ((idx >= lo[..., None]) & (idx < hi[..., None])).to(torch.float32)


def _ones(shape, n, device):
    return torch.ones((*shape, n), dtype=torch.float32, device=device)


def draw_narrowband_persistent(g, shape, nc, nt):
    """GPS / satellite: center ~ randint(0.1 nc, 0.9 nc), bandwidth ~
    randint(1, 10)."""
    return {"center_freq": _randint(g, nc * 0.1, nc * 0.9, shape),
            "bandwidth": _randint(g, 1, 10, shape)}


def narrowband_persistent_profile(p, nc, nt):
    """Channels [max(0, c - bw//2), c + bw//2 + 1), all times."""
    cf, bw = p["center_freq"], p["bandwidth"]
    f = _window(nc, (cf - bw // 2).clamp(min=0), cf + bw // 2 + 1)
    return f, _ones(cf.shape, nt, cf.device)


def draw_broadband_persistent(g, shape, nc, nt):
    """Power lines: center time ~ randint(0.1 nt, 0.9 nt), width ~
    randint(5, 50)."""
    return {"center_time": _randint(g, nt * 0.1, nt * 0.9, shape),
            "time_width": _randint(g, 5, 50, shape)}


def broadband_persistent_profile(p, nc, nt):
    """All channels, times [max(0, t - w//2), t + w//2)."""
    ct, tw = p["center_time"], p["time_width"]
    t = _window(nt, (ct - tw // 2).clamp(min=0), ct + tw // 2)
    return _ones(ct.shape, nc, ct.device), t


def draw_narrowband_intermittent(g, shape, nc, nt):
    """Rotating radar: center, bandwidth ~ randint(2, 15), period ~
    randint(20, 200), duty cycle ~ U(0.1, 0.5)."""
    return {"center_freq": _randint(g, nc * 0.1, nc * 0.9, shape),
            "bandwidth": _randint(g, 2, 15, shape),
            "period": _randint(g, 20, 200, shape),
            "duty_cycle": _uniform(g, 0.1, 0.5, shape)}


def narrowband_intermittent_profile(p, nc, nt):
    """Channels [max(0, c - bw//2), c + bw//2), active where
    ``t mod period < int(period * duty)``."""
    cf, bw, period = p["center_freq"], p["bandwidth"], p["period"]
    duration = (period.to(torch.float32) * p["duty_cycle"]).to(torch.int32)
    f = _window(nc, (cf - bw // 2).clamp(min=0), cf + bw // 2)
    tt = torch.arange(nt, device=cf.device)
    t = ((tt % period[..., None]) < duration[..., None]).to(torch.float32)
    return f, t


def draw_bursts(g, shape, nt, n_lo, n_hi, w_lo, w_hi):
    """Bursts of a bursty event: count ~ randint(n_lo, n_hi), n_hi - 1
    distinct start times (a permutation's head) and widths ~
    randint(w_lo, w_hi)."""
    max_bursts = n_hi - 1
    keys = torch.rand((*shape, nt), generator=g, device=g.device)
    return {"num_bursts": _randint(g, n_lo, n_hi, shape),
            "burst_times": keys.argsort(dim=-1)[..., :max_bursts],
            "burst_widths": _randint(g, w_lo, w_hi, (*shape, max_bursts))}


def bursty_time_profile(p, nt):
    """Union of the first ``num_bursts`` windows [max(0, t - w//2),
    t + w//2), float32 (..., nt)."""
    times, widths = p["burst_times"], p["burst_widths"]
    valid = torch.arange(times.shape[-1], device=times.device) < p["num_bursts"][..., None]
    windows = _window(nt, (times - widths // 2).clamp(min=0), times + widths // 2)
    return (windows * valid[..., None]).amax(dim=-2)


def draw_narrowband_bursty(g, shape, nc, nt):
    """Pulsed transmitters: a 2-20 channel band with 3-15 bursts of width
    2-20."""
    return {"center_freq": _randint(g, nc * 0.1, nc * 0.9, shape),
            "bandwidth": _randint(g, 2, 20, shape),
            **draw_bursts(g, shape, nt, 3, 15, 2, 20)}


def narrowband_bursty_profile(p, nc, nt):
    cf, bw = p["center_freq"], p["bandwidth"]
    f = _window(nc, (cf - bw // 2).clamp(min=0), cf + bw // 2)
    return f, bursty_time_profile(p, nt)


def draw_broadband_bursty(g, shape, nc, nt):
    """Lightning: 2-10 all-channel bursts of width 1-5."""
    return draw_bursts(g, shape, nt, 2, 10, 1, 5)


def broadband_bursty_profile(p, nc, nt):
    t = bursty_time_profile(p, nt)
    return _ones(t.shape[:-1], nc, t.device), t


# type -> (draw, profile)
SEPARABLE_TYPES = {
    "narrowband_persistent": (draw_narrowband_persistent,
                              narrowband_persistent_profile),
    "broadband_persistent": (draw_broadband_persistent,
                             broadband_persistent_profile),
    "narrowband_intermittent": (draw_narrowband_intermittent,
                                narrowband_intermittent_profile),
    "narrowband_bursty": (draw_narrowband_bursty, narrowband_bursty_profile),
    "broadband_bursty": (draw_broadband_bursty, broadband_bursty_profile),
}

EVENT_TYPES = list(SEPARABLE_TYPES) + ["frequency_sweep"]


def draw_sweep(g, shape, nc, nt):
    """A linear or quadratic chirp: start ~ randint(0.1 nc, 0.5 nc), end ~
    randint(0.5 nc, 0.9 nc), bandwidth ~ randint(2, 10), order 1 or 2."""
    return {"start_freq": _randint(g, nc * 0.1, nc * 0.5, shape),
            "end_freq": _randint(g, nc * 0.5, nc * 0.9, shape),
            "bandwidth": _randint(g, 2, 10, shape),
            "sweep_order": _randint(g, 1, 3, shape)}


def sweep_profile(p, nc, nt):
    """(..., nc, nt) bool mask of a sweep: at time t the channels
    [max(0, c(t) - bw//2), c(t) + bw//2) with ``c(t) = int(start + (end -
    start) * progress)``, progress t/nt (order 1) or (t/nt)^2, in float32
    as the reference rounds it."""
    start, end, bw = p["start_freq"], p["end_freq"], p["bandwidth"]
    t = torch.arange(nt, dtype=torch.float32, device=start.device) / nt
    progress = torch.where(p["sweep_order"][..., None] == 1, t, t * t)
    center = (start[..., None].to(torch.float32)
              + (end - start)[..., None].to(torch.float32) * progress).to(torch.int32)
    ch = torch.arange(nc, device=start.device)[:, None]
    lo = (center - bw[..., None] // 2).clamp(min=0)[..., None, :]
    hi = (center + bw[..., None] // 2)[..., None, :]
    return (ch >= lo) & (ch < hi)


def frequency_sweep_accumulate(g, nc, nt, max_events, count, amps):
    """Sum up to ``max_events`` sweeps per sample, the first ``count``
    valid.

    Args:
        g: ``torch.Generator`` on the output device.
        count: (B,) int number of valid sweeps per sample.
        amps: (B, max_events) float32 amplitudes.

    Returns:
        ``(signal (B, nc, nt) float32, mask (B, nc, nt) bool, params)``
        with params of shape (B, max_events).
    """
    b = amps.shape[0]
    params = draw_sweep(g, (b, max_events), nc, nt)
    signal = torch.zeros((b, nc, nt), dtype=torch.float32, device=amps.device)
    mask = torch.zeros((b, nc, nt), dtype=torch.bool, device=amps.device)
    for e in range(max_events):
        m = sweep_profile({k: v[:, e] for k, v in params.items()}, nc, nt)
        m = m & (e < count)[:, None, None]
        signal += amps[:, e, None, None] * m
        mask |= m
    return signal, mask, params
