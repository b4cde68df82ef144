"""Port parity: the flagging-quality statistics (MAD, statistics, FFI,
calcquality) against the JAX package, on the CPU.

Medians and MADs must be bit-equal (one sort, selection by rank, the same
float32 midpoint). Means and stds are float32 sums in another order:
they and everything computed from them (the flagged fraction, the FFI,
calcquality and its parts, some of which are differences of such sums
near 0) are held to 1e-5 relative or 1e-6 absolute, whichever is
larger."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.evaluation import statistics as JS
from rfi_toolbox_tpu_torch.evaluation import statistics as TS

RTOL = 1e-5
ATOL = 1e-6
EXACT = ("median", "mad", "mad_reduction")


def _data(rng, shape, kind):
    x = rng.normal(1.0, 1.0, shape)
    if kind == "complex128":
        return x + 1j * rng.normal(0.0, 1.0, shape)
    if kind == "complex64":
        return (x + 1j * rng.normal(0.0, 1.0, shape)).astype(np.complex64)
    return x.astype(np.float32) if kind == "float32" else x


def _assert_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k in EXACT or k == "count" or (isinstance(w, float) and np.isnan(w)):
            assert g == w or (np.isnan(g) and np.isnan(w)), (k, g, w)
        elif isinstance(w, dict):
            _assert_close(g, w)
        else:
            assert g == pytest.approx(w, rel=RTOL, abs=ATOL), k


@pytest.mark.parametrize("kind", ["float32", "float64", "complex64", "complex128"])
@pytest.mark.parametrize("shape", [(64, 64), (3, 4, 48, 40), (1001,)])
def test_statistics_match_jax(kind, shape):
    rng = np.random.default_rng(zlib.crc32(repr((kind, shape)).encode()))
    x = _data(rng, shape, kind)
    flags = rng.random(shape) > 0.7
    assert TS.compute_mad(x, device="cpu") == JS.compute_mad(x)
    _assert_close(TS.compute_statistics(x, device="cpu"), JS.compute_statistics(x))
    _assert_close(TS.compute_statistics(x, flags, device="cpu"),
                  JS.compute_statistics(x, flags))
    _assert_close(TS.compute_ffi(x, flags, device="cpu"), JS.compute_ffi(x, flags))
    _assert_close(TS.compute_calcquality(x, flags, device="cpu"),
                  JS.compute_calcquality(x, flags))


def test_rfi_flagging_scores_match_jax(rng):
    """tests/test_statistics.py's RFI stripe: a positive FFI and a
    calcquality against a separate reference array."""
    x = rng.normal(1.0, 0.1, (256, 256)).astype(np.float32)
    x[100:120, :] += 50.0
    flags = np.zeros((256, 256), bool)
    flags[100:120, :] = True
    got = TS.compute_ffi(x, flags, device="cpu")
    _assert_close(got, JS.compute_ffi(x, flags))
    assert got["ffi"] > 0
    ref = rng.normal(1.0, 0.1, (256, 256)).astype(np.float32)
    _assert_close(TS.compute_calcquality(x, flags, reference_data=ref, device="cpu"),
                  JS.compute_calcquality(x, flags, reference_data=ref))


def test_tensor_input_and_flags(rng):
    x = _data(rng, (32, 48), "complex64")
    flags = rng.random((32, 48)) > 0.5
    want = JS.compute_statistics(x, flags)
    _assert_close(TS.compute_statistics(torch.from_numpy(x), torch.from_numpy(flags),
                                        device="cpu"), want)


def test_all_flagged_and_degenerate_branches(rng):
    x = rng.normal(0, 1, (16, 16)).astype(np.float32)
    every = np.ones((16, 16), bool)
    got = TS.compute_statistics(x, every, device="cpu")
    _assert_close(got, JS.compute_statistics(x, every))
    assert got["count"] == 0 and got["flagged_fraction"] == 1.0
    got = TS.compute_ffi(x, every, device="cpu")
    assert got == JS.compute_ffi(x, every) == {
        "ffi": 0.0, "mad_reduction": 0.0, "std_reduction": 0.0, "flagged_fraction": 1.0}
    got = TS.compute_calcquality(x, every, device="cpu")
    assert got == JS.compute_calcquality(x, every)
    assert got["calcquality"] == float("inf") and got["flagged_pct"] == 100.0
    const = np.ones((8, 8), np.float32)  # rstd 0: degenerate, nothing flagged
    got = TS.compute_calcquality(const, np.zeros((8, 8), bool), device="cpu")
    assert got == JS.compute_calcquality(const, np.zeros((8, 8), bool))
    assert got["calcquality"] == float("inf")


def test_nan_input_medians(rng):
    x = rng.normal(0, 1, (40, 40)).astype(np.float32)
    x[3, 5] = np.nan
    assert np.isnan(TS.compute_mad(x, device="cpu")) and np.isnan(JS.compute_mad(x))
    flags = np.zeros((40, 40), bool)
    flags[:4] = True  # the NaN is flagged: the rest is finite
    _assert_close(TS.compute_statistics(x, flags, device="cpu"),
                  JS.compute_statistics(x, flags))


def test_median_ranks_above_2_24():
    """jnp.median computes its middle ranks from 0.5 * (n - 1) in float32,
    which rounds for n > 2**24: the port reads the ranks JAX reads."""
    n = 2**24 + 2  # n - 1 rounds to 2**24: both ranks are n // 2 - 1
    x = np.random.default_rng(3).permutation(n).astype(np.float32)
    want = float(jnp.median(jnp.asarray(x)))
    assert float(TS._median(torch.from_numpy(x))) == want
    assert want == n // 2 - 1 != np.median(x.astype(np.float64))


def test_print_statistics_comparison(rng, capsys):
    x = rng.normal(1.0, 0.1, (64, 64)).astype(np.float32)
    x[10:12] += 20.0
    flags = np.zeros((64, 64), bool)
    flags[10:12] = True
    JS.print_statistics_comparison(x, flags)
    want = capsys.readouterr().out
    TS.print_statistics_comparison(x, flags, device="cpu")
    assert capsys.readouterr().out == want


def test_statistics_want_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    x = rng.normal(0, 1, (8, 8)).astype(np.float32)
    flags = np.zeros((8, 8), bool)
    for fn, args in ((TS.compute_mad, (x,)), (TS.compute_statistics, (x,)),
                     (TS.compute_ffi, (x, flags)), (TS.compute_calcquality, (x, flags))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
