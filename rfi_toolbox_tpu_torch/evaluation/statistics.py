"""Flagging-quality statistics (MAD, FFI, calcquality) on the card.

Counterpart of ``rfi_toolbox_tpu/evaluation/statistics.py``, with its
semantics and edge cases:

- ``compute_mad``: median(|x - median(x)|);
- ``compute_statistics``: magnitude for complex input; unflagged
  mean/median/std/mad/count/flagged_fraction; all flagged -> NaNs and
  flagged_fraction 1.0;
- ``compute_ffi``: mad/std reduction, ffi = 0.5*(madr+stdr)*(1-0.5*pflag);
  all flagged -> zeros;
- ``compute_calcquality``: a=||maxdev|-3|, b=|fmean-rmean|/rstd - 1,
  c=|fstd-rstd|/rstd, d=max(0,(pflag-70)/10), score=sqrt(a²+b²+c²+d²),
  inf on degenerate input.

The masked statistics keep JAX's static-shape design: flagged entries are
pushed to +inf, one sort per median, and the median is read by rank from
the sorted array. Complex input becomes complex64 and then its magnitude
by :func:`~rfi_toolbox_tpu_torch.preprocess.pipeline.magnitude`, which is
jnp.abs's bit for bit. Medians and MADs are bit-equal to JAX's; means and
stds are float32 sums in another order (within 1e-5 relative of JAX's).
Each function takes ``device=None`` (the card) or e.g. ``"cpu"``.
"""

import numpy as np
import torch

from ..preprocess.pipeline import magnitude
from ..utils.device import resolve_device

__all__ = [
    "compute_mad",
    "compute_statistics",
    "compute_ffi",
    "compute_calcquality",
    "print_statistics_comparison",
]


def _to_magnitude(data, device):
    """numpy array or tensor -> float32 tensor on ``device``; complex
    input (cast to complex64 first, as JAX does with 64-bit types off)
    -> its magnitude."""
    x = data.detach() if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data))
    if x.is_complex():
        return magnitude(x.to(device=device, dtype=torch.complex64))
    return x.to(device=device, dtype=torch.float32)


def _to_flags(flags, device):
    if isinstance(flags, torch.Tensor):
        return flags.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(flags)).to(device=device, dtype=torch.bool)


def _median(flat):
    """``jnp.median`` of a 1-d float32 tensor as JAX computes it: NaN if
    any entry is NaN, else the mean of the sorted values at floor(q) and
    ceil(q), with q = 0.5 * (n - 1) in float32 (for n > 2**24 that
    rounds, and JAX reads the ranks it rounds to)."""
    n = flat.numel()
    q = np.float32(0.5) * (np.float32(n) - np.float32(1))
    last = np.float32(n) - np.float32(1)
    low = int(np.clip(np.floor(q), np.float32(0), last))
    high = int(np.clip(np.ceil(q), np.float32(0), last))
    s = torch.sort(flat).values
    mid = (s[low] + s[high]) * 0.5
    return torch.where(torch.isnan(flat).any(), torch.nan, mid)


def _masked_median(sorted_vals, count):
    """Median of the first ``count`` entries of an ascending-sorted array
    (flagged entries were pushed to +inf before the sort): numpy's mean
    of the middle two."""
    safe = count.clamp(min=1).long()
    lo = sorted_vals[(safe - 1) // 2]
    hi = sorted_vals[safe // 2]
    return 0.5 * (lo + hi)


def _masked_stats(data, keep):
    """mean/median/std/mad/count (0-dim tensors) over entries where
    ``keep`` is True; all masked -> NaN stats and count 0."""
    flat = data.reshape(-1)
    keep = keep.reshape(-1)
    count = keep.sum(dtype=torch.int32)
    fcount = count.clamp(min=1).to(torch.float32)

    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    mean = torch.where(keep, flat, zero).sum() / fcount
    var = torch.where(keep, (flat - mean) ** 2, zero).sum() / fcount
    std = torch.sqrt(var)

    median = _masked_median(torch.sort(torch.where(keep, flat, torch.inf)).values, count)
    absdev = torch.where(keep, (flat - median).abs(), torch.inf)
    mad = _masked_median(torch.sort(absdev).values, count)

    empty = count == 0
    nan = torch.full((), torch.nan, device=flat.device)
    return {
        "mean": torch.where(empty, nan, mean),
        "median": torch.where(empty, nan, median),
        "std": torch.where(empty, nan, std),
        "mad": torch.where(empty, nan, mad),
        "count": count,
    }


def compute_mad(data, device=None):
    """Median Absolute Deviation: median(|x - median(x)|)."""
    flat = _to_magnitude(data, resolve_device(device)).reshape(-1)
    return float(_median((flat - _median(flat)).abs()))


def compute_statistics(data, flags=None, device=None):
    """Descriptive statistics of the unflagged portion of ``data``.

    Args:
        data: complex or real array or tensor.
        flags: optional boolean mask, True = flagged (excluded).
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.

    Returns:
        dict: mean, median, std, mad, count, flagged_fraction (python
        scalars; all flagged -> NaNs, count 0, fraction 1.0).
    """
    dev = resolve_device(device)
    data = _to_magnitude(data, dev)
    if flags is None:
        keep = torch.ones(data.shape, dtype=torch.bool, device=dev)
        flagged_fraction = 0.0
    else:
        flags = _to_flags(flags, dev)
        keep = ~flags
        flagged_fraction = float(flags.to(torch.float32).mean())

    out = _masked_stats(data, keep)
    count = int(out["count"])
    if count == 0:
        return {"mean": float("nan"), "median": float("nan"), "std": float("nan"),
                "mad": float("nan"), "count": 0, "flagged_fraction": 1.0}
    return {
        "mean": float(out["mean"]),
        "median": float(out["median"]),
        "std": float(out["std"]),
        "mad": float(out["mad"]),
        "count": count,
        "flagged_fraction": float(flagged_fraction),
    }


def compute_ffi(data, flags, device=None):
    """Flagging Fidelity Index. Higher = better flagging.

    ffi = 0.5*(mad_reduction + std_reduction) * (1 - 0.5*flagged_fraction);
    all-flagged input returns zeros (and flagged_fraction 1).
    """
    dev = resolve_device(device)
    data = _to_magnitude(data, dev)
    flags = _to_flags(flags, dev)
    before = _masked_stats(data, torch.ones(data.shape, dtype=torch.bool, device=dev))
    after = _masked_stats(data, ~flags)
    flagged_fraction = flags.to(torch.float32).mean()

    mad_reduction = 1.0 - after["mad"] / before["mad"]
    std_reduction = 1.0 - after["std"] / before["std"]
    ffi = (0.5 * mad_reduction + 0.5 * std_reduction) * (1.0 - 0.5 * flagged_fraction)
    if int(after["count"]) == 0:
        return {"ffi": 0.0, "mad_reduction": 0.0, "std_reduction": 0.0,
                "flagged_fraction": 1.0}
    return {"ffi": float(ffi), "mad_reduction": float(mad_reduction),
            "std_reduction": float(std_reduction),
            "flagged_fraction": float(flagged_fraction)}


def compute_calcquality(data, flags, reference_data=None, device=None):
    """calcquality score (lower is better).

    Components:
        a = ||maxdev| - 3|      (sensitivity)
        b = |fmean - rmean|/rstd - 1
        c = |fstd - rstd|/rstd
        d = max(0, (pflag - 70)/10)
        score = sqrt(a^2 + b^2 + c^2 + d^2)
    Degenerate input (all flagged or rstd < 1e-10) -> inf components.
    """
    dev = resolve_device(device)
    data = _to_magnitude(data, dev)
    flags = _to_flags(flags, dev)
    ref = data if reference_data is None else _to_magnitude(reference_data, dev)

    ref_stats = _masked_stats(ref, torch.ones(ref.shape, dtype=torch.bool, device=dev))
    flag_stats = _masked_stats(data, ~flags)
    pflag = float(flags.to(torch.float32).mean()) * 100.0

    rmean = float(ref_stats["mean"])
    rstd = float(ref_stats["std"])
    fmean = float(flag_stats["mean"])
    fstd = float(flag_stats["std"])

    if np.isnan(fmean) or np.isnan(fstd) or rstd < 1e-10:
        return {"calcquality": float("inf"), "sensitivity": float("inf"),
                "mean_shift": float("inf"), "std_shift": float("inf"),
                "overflagging_penalty": float("inf"), "flagged_pct": float(pflag),
                "components": {}}

    rmax = float(ref.max())
    maxdev = (rmax - rmean) / rstd
    fdiff = fmean - rmean
    sdiff = fstd - rstd

    a = abs(abs(maxdev) - 3)
    b = abs(fdiff) / rstd - 1
    c = abs(sdiff) / rstd
    d = max(0.0, (pflag - 70.0) / 10.0)
    return {
        "calcquality": float(np.sqrt(a**2 + b**2 + c**2 + d**2)),
        "sensitivity": float(a),
        "mean_shift": float(b),
        "std_shift": float(c),
        "overflagging_penalty": float(d),
        "flagged_pct": float(pflag),
        "components": {"rmean": rmean, "rstd": rstd, "fmean": fmean, "fstd": fstd,
                       "rmax": rmax, "maxdev": float(maxdev), "fdiff": float(fdiff),
                       "sdiff": float(sdiff)},
    }


def print_statistics_comparison(data, flags, device=None):
    """Formatted before/after statistics + FFI report."""
    stats_before = compute_statistics(data, flags=None, device=device)
    stats_after = compute_statistics(data, flags=flags, device=device)
    ffi_metrics = compute_ffi(data, flags, device=device)

    print("\n" + "=" * 60)
    print("Statistics Comparison (Before/After Flagging)")
    print("=" * 60)

    print("\nBefore Flagging:")
    print(f"  Mean:   {stats_before['mean']:.4e}")
    print(f"  Median: {stats_before['median']:.4e}")
    print(f"  Std:    {stats_before['std']:.4e}")
    print(f"  MAD:    {stats_before['mad']:.4e}")
    print(f"  Count:  {stats_before['count']}")

    print(f"\nAfter Flagging ({stats_after['flagged_fraction']*100:.2f}% flagged):")
    print(f"  Mean:   {stats_after['mean']:.4e}")
    print(f"  Median: {stats_after['median']:.4e}")
    print(f"  Std:    {stats_after['std']:.4e}")
    print(f"  MAD:    {stats_after['mad']:.4e}")
    print(f"  Count:  {stats_after['count']}")

    print("\nFlagging Fidelity Index (FFI):")
    print(f"  FFI:            {ffi_metrics['ffi']:.4f}")
    print(f"  MAD Reduction:  {ffi_metrics['mad_reduction']:.4f}")
    print(f"  STD Reduction:  {ffi_metrics['std_reduction']:.4f}")
