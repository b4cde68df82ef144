"""The one traffic generator: complex64 waterfalls with RFI and their
exact masks, made on the device from the seed.

A plain-torch rewrite of ``chip_smoke.py:make_waterfalls``, with its
numbers read from a traffic mix's ``waterfalls`` entry: |noise| ``1 +-
noise`` (a normal), RFI of ``rfi`` [lo, hi) (uniform) added in channel
stripes (narrowband, every integration), time bursts (broadband, every
channel) and blocks, a uniform random phase. A stripe's first channel
is uniform in [0, C - width_hi], its width uniform in [lo, hi); bursts
and blocks likewise. Every draw comes from one ``torch.Generator`` on
the device, seeded with the run's seed, in a fixed order, so a seed
gives the same pool on every run, and every seed the same sizes.
"""

import math

import torch


def _starts(g, m, count, span, lo, hi, device):
    """(m, count) first indices and widths of ``count`` features a
    waterfall along an axis of ``span``."""
    start = torch.randint(0, span - hi + 2, (m, count), generator=g, device=device)
    width = torch.randint(lo, hi, (m, count), generator=g, device=device)
    return start, width


def _covered(start, width, span):
    """(m, span) bool: positions covered by any of the (m, count)
    features."""
    pos = torch.arange(span, device=start.device)[None, None, :]
    return ((pos >= start[..., None]) & (pos < (start + width)[..., None])).any(dim=1)


def make_block(spec, g, device):
    """One block of ``spec["count"]`` waterfalls of ``spec["channels"]`` x
    ``spec["times"]``: (complex64 waterfalls, bool mask)."""
    m, c, t = spec["count"], spec["channels"], spec["times"]
    stripes, bursts, blocks = spec["stripes"], spec["bursts"], spec["blocks"]
    s0, sw = _starts(g, m, stripes["count"], c, *stripes["width"], device)
    b0, bw = _starts(g, m, bursts["count"], t, *bursts["width"], device)
    mask = _covered(s0, sw, c)[:, :, None] | _covered(b0, bw, t)[:, None, :]
    lo, hi = blocks["size"]
    for _ in range(blocks["count"]):
        r0, rh = _starts(g, m, 1, c, lo, hi, device)
        c0, cw = _starts(g, m, 1, t, lo, hi, device)
        mask |= _covered(r0, rh, c)[:, :, None] & _covered(c0, cw, t)[:, None, :]
    amp = 1.0 + spec["noise"] * torch.randn((m, c, t), generator=g, device=device)
    rfi = torch.empty((m, c, t), device=device).uniform_(*spec["rfi"], generator=g)
    amp = torch.where(mask, amp + rfi, amp)
    phase = torch.empty((m, c, t), device=device).uniform_(0.0, 2 * math.pi, generator=g)
    return torch.polar(amp, phase), mask


def make_pool(spec, size, seed, device):
    """``size`` distinct blocks, [(waterfalls, mask), ...], from ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return [make_block(spec, g, device) for _ in range(size)]
