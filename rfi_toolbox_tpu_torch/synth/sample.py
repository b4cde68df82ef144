"""Synthetic waterfall batches on the card.

Counterpart of ``rfi_toolbox_tpu/synth/sample.py`` (``generate_bandpass``,
``make_sample_generator``, ``make_instance_sample_generator``,
``params_to_event_list``). Where the JAX package ``vmap``s one sample over keys, the
port draws a whole batch on the device in one call: the separable event
stack becomes two batched matrix products, the sweeps a loop over their
few events. Laws, units (RFI amplitudes in mJy, drawn in Jy x 1000) and
the per-polarisation rules are the reference's; the random stream is a
``torch.Generator``'s.
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from . import events as E

__all__ = ["make_sample_generator", "make_instance_sample_generator",
           "generate_bandpass", "params_to_event_list"]


def _as_range(value):
    """Scalar or [min, max] -> (min, max) floats."""
    if isinstance(value, (list, tuple)):
        return float(value[0]), float(value[1])
    return float(value), float(value)


def _count_range(value):
    """Event count: int or [min, max] inclusive -> (lo, hi)."""
    if isinstance(value, (list, tuple)):
        return int(value[0]), int(value[1])
    return int(value), int(value)


def _count(g, lo, hi, b):
    """(b,) event counts on the generator's device: ``lo``, or drawn
    uniformly from [lo, hi]."""
    if lo == hi:
        return torch.full((b,), lo, dtype=torch.int64, device=g.device)
    return torch.randint(lo, hi + 1, (b,), generator=g, device=g.device)


def _integer_pow(x, y):
    """x ** y for a positive int y by binary exponentiation, the
    multiplications in the order XLA's ``integer_pow`` does them."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def generate_bandpass(num_channels, order, device=None):
    """(num_channels,) float32 polynomial roll-off over the outer 10% of
    channels at both ends. ``device``: ``None`` for the CUDA card."""
    dev = resolve_device(device)
    edge = int(num_channels * 0.1)
    idx = torch.arange(num_channels, device=dev)
    bp = torch.ones(num_channels, dtype=torch.float32, device=dev)
    if edge == 0:
        return bp
    # XLA rewrites the division by the constant edge as a product with
    # its float32 reciprocal; the port does the same, bit for bit
    inv = torch.tensor(1.0 / edge, dtype=torch.float32, device=dev)
    lo_t = idx.to(torch.float32) * inv
    hi_t = (num_channels - 1 - idx).to(torch.float32) * inv
    bp = torch.where(idx < edge, _integer_pow(lo_t, order), bp)
    return torch.where(idx >= num_channels - edge, _integer_pow(hi_t, order), bp)


def make_sample_generator(num_channels, num_times, noise_level=1.0,
                          rfi_power_min=1000.0, rfi_power_max=10000.0,
                          rfi_config=None, enable_bandpass=False,
                          bandpass_order=8, num_polarizations=1, pol_corr=0.8,
                          device=None):
    """Build ``sample_fn(batch, generator) -> (waterfall, mask, params)``.

    Args mirror the JAX package's; ``rfi_config`` maps event type ->
    ``{"count": int | [min, max]}``. ``device``: ``None`` for the CUDA
    card. ``generator`` must be a ``torch.Generator`` on that device.

    Returns ``sample_fn`` producing, for ``batch`` samples:
        waterfall: (batch, num_polarizations, nc, nt) complex64
        mask: (batch, num_polarizations, nc, nt) bool, the exact support
            of the injected RFI
        params: event type -> dict of (batch, max events) parameter
            tensors, with ``amplitude_mjy`` and ``_count`` (batch,)
    """
    dev = resolve_device(device)
    nc, nt = int(num_channels), int(num_times)
    npol = int(num_polarizations)
    pol_corr = float(pol_corr)
    noise_rng = _as_range(noise_level)
    pmin_rng = _as_range(rfi_power_min)
    pmax_rng = _as_range(rfi_power_max)
    if rfi_config is None:
        rfi_config = {t: {"count": 1} for t in E.SEPARABLE_TYPES}
    sep_counts = {}
    for name in E.SEPARABLE_TYPES:
        lo, hi = _count_range(rfi_config.get(name, {}).get("count", 0))
        if hi > 0:
            sep_counts[name] = (lo, hi)
    sweep_lo, sweep_hi = _count_range(
        rfi_config.get("frequency_sweep", {}).get("count", 0))
    bandpass = (generate_bandpass(nc, int(bandpass_order), dev)
                if enable_bandpass else None)

    def sample_fn(batch, generator):
        g, b = generator, int(batch)
        if g.device.type != dev.type:
            raise ValueError(f"generator on {g.device}, samples on {dev}")
        noise = E._uniform(g, *noise_rng, (b, 1, 1))
        pmin = E._uniform(g, *pmin_rng, (b, 1))
        pmax = E._uniform(g, *pmax_rng, (b, 1))
        baseline = noise + noise * 0.1 * torch.randn((b, nc, nt), generator=g,
                                                     device=dev)
        if bandpass is not None:
            baseline = baseline * bandpass[:, None]

        params = {}
        f_rows, t_rows, amp_rows = [], [], []
        for name, (lo, hi) in sep_counts.items():
            draw, profile = E.SEPARABLE_TYPES[name]
            count = _count(g, lo, hi, b)
            p = draw(g, (b, hi), nc, nt)
            f, t = profile(p, nc, nt)
            valid = torch.arange(hi, device=dev) < count[:, None]
            amps = E._uniform(g, pmin, pmax, (b, hi)) * 1000.0  # Jy -> mJy
            f_rows.append(f * valid[..., None])
            t_rows.append(t)
            amp_rows.append(amps)
            params[name] = {**p, "amplitude_mjy": amps, "_count": count}
        if f_rows:
            f = torch.cat(f_rows, dim=1)  # (b, E, nc)
            t = torch.cat(t_rows, dim=1)  # (b, E, nt)
            amps = torch.cat(amp_rows, dim=1)
            rfi_signal = (f * amps[..., None]).transpose(1, 2) @ t
            rfi_mask = ((f > 0).to(torch.float32).transpose(1, 2)
                        @ (t > 0).to(torch.float32)) > 0
        else:
            rfi_signal = torch.zeros((b, nc, nt), dtype=torch.float32, device=dev)
            rfi_mask = torch.zeros((b, nc, nt), dtype=torch.bool, device=dev)

        if sweep_hi > 0:
            count = _count(g, sweep_lo, sweep_hi, b)
            amps = E._uniform(g, pmin, pmax, (b, sweep_hi)) * 1000.0
            s_sig, s_mask, s_params = E.frequency_sweep_accumulate(
                g, nc, nt, sweep_hi, count, amps)
            rfi_signal = rfi_signal + s_sig
            rfi_mask = rfi_mask | s_mask
            params["frequency_sweep"] = {**s_params, "amplitude_mjy": amps,
                                         "_count": count}

        pols, masks = [], []
        for pol in range(npol):
            if pol == 0:
                pols.append(baseline + rfi_signal)
                masks.append(rfi_mask)
            elif pol == 1:
                corr_noise = noise * 0.1 * torch.randn((b, nc, nt), generator=g,
                                                       device=dev)
                pols.append(pol_corr * rfi_signal + (1 - pol_corr) * corr_noise
                            + baseline)
                masks.append(rfi_mask)
            else:
                pols.append(noise + noise * 0.1 * torch.randn(
                    (b, nc, nt), generator=g, device=dev))
                masks.append(torch.zeros_like(rfi_mask))
        amplitude = torch.stack(pols, dim=1)
        phase = E._uniform(g, 0.0, 2.0 * torch.pi, (b, npol, nc, nt))
        waterfall = torch.complex(amplitude * torch.cos(phase),
                                  amplitude * torch.sin(phase))
        return waterfall, torch.stack(masks, dim=1), params

    return sample_fn


def make_instance_sample_generator(num_channels, num_times, noise_level=1.0,
                                   rfi_power_min=1000.0, rfi_power_max=10000.0,
                                   rfi_config=None, max_instances=None, device=None):
    """Build ``sample_fn(batch, generator) -> dict`` with one ground-truth
    mask per RFI event (the supervision SOLOLite trains on); the class id
    of an event is its type's index in ``events.EVENT_TYPES``.

    Args mirror the JAX package's; ``rfi_config`` maps event type ->
    ``{"count": int | [min, max]}`` (default: one of each of the six
    types). ``device``: ``None`` for the CUDA card; ``generator`` must be
    a ``torch.Generator`` on that device.

    Returns ``sample_fn`` producing, for ``batch`` samples:
        waterfall: (batch, nc, nt) complex64, single polarisation
        inst_masks: (batch, M, nc, nt) bool
        inst_classes: (batch, M) int32
        inst_valid: (batch, M) bool
    where M is the sum of the types' highest counts; rows past a sample's
    drawn count, and events occluded to no pixel, are invalid (their rows
    all False, or empty).
    """
    dev = resolve_device(device)
    nc, nt = int(num_channels), int(num_times)
    noise_rng = _as_range(noise_level)
    pmin_rng = _as_range(rfi_power_min)
    pmax_rng = _as_range(rfi_power_max)
    if rfi_config is None:
        rfi_config = {t: {"count": 1} for t in E.EVENT_TYPES}
    sep_counts = {}
    for name in E.SEPARABLE_TYPES:
        lo, hi = _count_range(rfi_config.get(name, {}).get("count", 0))
        if hi > 0:
            sep_counts[name] = (lo, hi)
    sweep_lo, sweep_hi = _count_range(
        rfi_config.get("frequency_sweep", {}).get("count", 0))
    class_ids = {name: i for i, name in enumerate(E.EVENT_TYPES)}
    total_sep = sum(hi for _, hi in sep_counts.values())
    total_m = total_sep + sweep_hi
    if max_instances is not None and total_m > max_instances:
        raise ValueError(f"max event count {total_m} exceeds max_instances={max_instances}")

    def sample_fn(batch, generator):
        g, b = generator, int(batch)
        if g.device.type != dev.type:
            raise ValueError(f"generator on {g.device}, samples on {dev}")
        noise = E._uniform(g, *noise_rng, (b, 1, 1))
        pmin = E._uniform(g, *pmin_rng, (b, 1))
        pmax = E._uniform(g, *pmax_rng, (b, 1))
        baseline = noise + noise * 0.1 * torch.randn((b, nc, nt), generator=g, device=dev)
        # the separable events' amplitudes, one draw for all types
        amps = E._uniform(g, pmin, pmax, (b, total_sep)) * 1000.0  # Jy -> mJy
        masks, classes, valids = [], [], []
        for name, (lo, hi) in sep_counts.items():
            draw, profile = E.SEPARABLE_TYPES[name]
            count = _count(g, lo, hi, b)
            f, t = profile(draw(g, (b, hi), nc, nt), nc, nt)  # (b, hi, nc), (b, hi, nt)
            masks.append((f[..., :, None] > 0) & (t[..., None, :] > 0))
            valids.append(torch.arange(hi, device=dev) < count[:, None])
            classes.append(torch.full((b, hi), class_ids[name], dtype=torch.int32,
                                      device=dev))
        if sweep_hi > 0:
            count = _count(g, sweep_lo, sweep_hi, b)
            sweep_amps = E._uniform(g, pmin, pmax, (b, sweep_hi)) * 1000.0
            amps = torch.cat([amps, sweep_amps], dim=1)
            # one mask per sweep (frequency_sweep_accumulate ORs them)
            masks.append(E.sweep_profile(E.draw_sweep(g, (b, sweep_hi), nc, nt), nc, nt))
            valids.append(torch.arange(sweep_hi, device=dev) < count[:, None])
            classes.append(torch.full((b, sweep_hi), class_ids["frequency_sweep"],
                                      dtype=torch.int32, device=dev))
        if masks:
            inst_valid = torch.cat(valids, dim=1)
            inst_masks = torch.cat(masks, dim=1) & inst_valid[..., None, None]
            inst_classes = torch.cat(classes, dim=1)
            signal = torch.einsum("bm,bmct->bct", amps * inst_valid,
                                  inst_masks.to(torch.float32))
        else:
            inst_masks = torch.zeros((b, 0, nc, nt), dtype=torch.bool, device=dev)
            inst_classes = torch.zeros((b, 0), dtype=torch.int32, device=dev)
            inst_valid = torch.zeros((b, 0), dtype=torch.bool, device=dev)
            signal = 0.0
        # an instance occluded to zero pixels is invalid
        inst_valid = inst_valid & inst_masks.flatten(2).any(dim=2)
        amplitude = baseline + signal
        phase = E._uniform(g, 0.0, 2.0 * torch.pi, (b, nc, nt))
        waterfall = torch.complex(amplitude * torch.cos(phase), amplitude * torch.sin(phase))
        return {"waterfall": waterfall, "inst_masks": inst_masks,
                "inst_classes": inst_classes, "inst_valid": inst_valid}

    return sample_fn


def params_to_event_list(params):
    """Host side: a params dict of ``sample_fn`` (event type -> field ->
    (batch, max events) tensor, ``_count`` (batch,)), or of one sample
    (no batch axis), as the reference's per-event dict list, valid events
    only: one list a sample for a batch. Types and fields are taken in
    sorted order, as the JAX package's pytree walk takes them; floating
    fields become floats, the rest ints. Fields with more than one value
    an event (the bursts' sub-burst times and widths, which the JAX
    package's params do not carry) are left out. Numpy arrays are taken
    too."""
    params = {t: {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v)) for k, v in sorted(fields.items())}
              for t, fields in sorted(params.items())}
    sample0 = next(iter(params.values()))["_count"]
    per_event = np.ndim(sample0) + 1  # dims of a field with one value an event

    def one_sample(p):
        out = []
        for rfi_type, fields in p.items():
            count = int(fields["_count"])
            keys = [k for k in fields if not k.startswith("_")]
            for e in range(count):
                entry = {"type": rfi_type}
                for k in keys:
                    v = fields[k][e]
                    entry[k] = (float(v) if np.issubdtype(np.asarray(v).dtype, np.floating)
                                else int(v))
                out.append(entry)
        return out

    params = {t: {k: v for k, v in fields.items()
                  if k.startswith("_") or np.ndim(v) == per_event}
              for t, fields in params.items()}
    if np.ndim(sample0) == 0:
        return one_sample(params)
    return [one_sample({t: {k: v[i] for k, v in fields.items()}
                        for t, fields in params.items()})
            for i in range(np.shape(sample0)[0])]
