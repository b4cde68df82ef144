"""Port parity: flagging a whole Measurement Set (flag_measurement_set)
and RFIMaskDataset against the JAX package, on the CPU.

Both packages build the same FakeMS and inject the same visibilities.
With ``method="mad"`` the written FLAG columns and the result dicts must
be equal, bit for bit, in bulk and streaming modes, with merge_existing,
reported failures and the ragged fallback. With the shipped UNet16
snapshots (``method="model"``, ``"model8"``) the columns must agree on
>= 99.9% of the pixels, the served-mask rule. RFIMaskDataset's tensors
must equal JAX's numpy arrays for every normalisation."""

import logging

import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.data import RFIMaskDataset as JaxMaskDataset
from rfi_toolbox_tpu.io import MSLoader as JaxLoader
from rfi_toolbox_tpu.io import flag_measurement_set as jax_flag_ms
from rfi_toolbox_tpu.io import inject_synthetic_data as jax_inject
from rfi_toolbox_tpu.io import make_fake_ms as jax_make_fake_ms
from rfi_toolbox_tpu.io import ms_loader as jax_ms_loader
from rfi_toolbox_tpu.serving import CompiledPredictor as JaxPredictor
from rfi_toolbox_tpu_torch.data import RFIMaskDataset
from rfi_toolbox_tpu_torch.io import (
    MSLoader,
    flag_measurement_set,
    inject_synthetic_data,
    make_fake_ms,
)
from rfi_toolbox_tpu_torch.io import ms_loader as port_ms_loader
from rfi_toolbox_tpu_torch.serving import CompiledPredictor

MASK_AGREE = 0.999


def _rfi_vis(rng, n_bl, nchan, ntime):
    """Unit noise with channel stripes and time bursts of 3e3, random
    phase (tests/test_flagging.py's observation)."""
    base = rng.normal(1.0, 0.1, (n_bl, 4, nchan, ntime))
    base[:, :, nchan // 3:nchan // 3 + 4, :] += 3e3
    base[:, :, :, ntime // 2:ntime // 2 + 5] += 3e3
    base[1, 2, 5:9, 3:40] += 5e2
    return base * np.exp(1j * rng.uniform(0, 2 * np.pi, base.shape))


def _both_ms(n_ant=3, spws=(32,), ntime=32, seed=0):
    """The same injected observation in a port FakeMS and a JAX FakeMS."""
    n_bl = n_ant * (n_ant - 1) // 2
    vis = _rfi_vis(np.random.default_rng(seed), n_bl, sum(spws), ntime)
    kw = dict(num_antennas=n_ant, channels_per_spw=spws, num_times=ntime, seed=None)
    port, ref = make_fake_ms(**kw), jax_make_fake_ms(**kw)
    inject_synthetic_data(port, vis, output_ms_path=port)
    jax_inject(ref, vis, output_ms_path=ref)
    return port, ref


def _flag_column(ms):
    return np.stack([r["FLAG"] for r in ms.rows])


def _assert_same_flags(port, ref):
    got, want = _flag_column(port), _flag_column(ref)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("use_pallas", ["auto", False])
@pytest.mark.parametrize("streaming", [False, True], ids=["bulk", "streaming"])
@pytest.mark.parametrize("geometry", [dict(spws=(32, 32), ntime=48, patch_size=32),
                                      dict(spws=(24,), ntime=20, patch_size=32),
                                      dict(n_ant=4, spws=(64,), ntime=64, patch_size=128)],
                         ids=["2spw-patched", "one-patch", "4ant"])
def test_mad_matches_jax(geometry, streaming, use_pallas):
    geometry = dict(geometry)
    patch = geometry.pop("patch_size")
    port, ref = _both_ms(**geometry)
    got = flag_measurement_set(port, method="mad", sigma=5.0, patch_size=patch,
                               streaming=streaming, use_pallas=use_pallas, device="cpu")
    want = jax_flag_ms(ref, method="mad", sigma=5.0, patch_size=patch, streaming=streaming,
                       use_pallas=False)
    assert got == want
    flags = _assert_same_flags(port, ref)
    assert 0.0 < flags.mean() < 0.5


def test_streaming_equals_bulk():
    port, _ = _both_ms(spws=(32, 32), ntime=32)
    stream = port.copy()
    flag_measurement_set(port, patch_size=32, device="cpu")
    flag_measurement_set(stream, patch_size=32, streaming=True, device="cpu")
    np.testing.assert_array_equal(_flag_column(port), _flag_column(stream))


@pytest.mark.parametrize("streaming", [False, True], ids=["bulk", "streaming"])
def test_merge_existing_matches_jax(streaming):
    """Flags set beforehand survive a merge and are overwritten without
    one."""
    port, ref = _both_ms(spws=(32, 32), ntime=32)
    pre = np.zeros((4, 64, 32), bool)
    pre[0, 0, 0] = pre[3, 40, 7] = True
    MSLoader(port).save_baseline_flags(0, 1, pre)
    JaxLoader(ref).save_baseline_flags(0, 1, pre)
    for merge in (True, False):
        got = flag_measurement_set(port, patch_size=32, merge_existing=merge,
                                   streaming=streaming, device="cpu")
        want = jax_flag_ms(ref, patch_size=32, merge_existing=merge, streaming=streaming)
        assert got == want
        _assert_same_flags(port, ref)
        back = MSLoader(port).load_baseline_flags(0, 1)
        assert back[0, 0, 0] == back[3, 40, 7] == merge


def test_reported_failures_match_jax(monkeypatch):
    port, ref = _both_ms(ntime=16)
    for module in (port_ms_loader, jax_ms_loader):
        orig = module.MSLoader.load_baseline

        def flaky(self, ant1, ant2, _orig=orig, **kw):
            if (ant1, ant2) == (0, 2):
                raise IOError("disk on fire")
            return _orig(self, ant1, ant2, **kw)

        monkeypatch.setattr(module.MSLoader, "load_baseline", flaky)
    got = flag_measurement_set(port, patch_size=32, streaming=True, device="cpu")
    want = jax_flag_ms(ref, patch_size=32, streaming=True)
    assert got == want
    assert got["baselines"] == 2
    assert got["failed"] == [{"baseline": (0, 2), "error": "disk on fire"}]
    _assert_same_flags(port, ref)


def test_ragged_falls_back_to_streaming(caplog):
    """Baseline (0, 1) loses its last 8 integrations: the bulk load
    raises and the per-baseline path flags every baseline."""
    port, ref = _both_ms(ntime=32)
    for ms in (port, ref):
        ms.rows = [r for r in ms.rows if not (r["ANTENNA1"] == 0 and r["ANTENNA2"] == 1
                                             and r["TIME"] >= 5e9 + 24)]
    with caplog.at_level(logging.WARNING, logger="rfi_toolbox_tpu_torch.io.flagging"):
        got = flag_measurement_set(port, patch_size=32, device="cpu")
    assert any("falling back" in r.message for r in caplog.records)
    want = jax_flag_ms(ref, patch_size=32)
    assert got == want == {"baselines": 3, "flagged_fraction": got["flagged_fraction"],
                           "failed": []}
    _assert_same_flags(port, ref)


def test_errors_propagate(monkeypatch):
    """Only a ValueError from the bulk load is caught: an error of the
    flagging call reaches the caller, in both modes."""
    port, _ = _both_ms(ntime=16)
    from rfi_toolbox_tpu_torch.io import flagging

    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(flagging, "mad_flag_patches", broken)
    for streaming in (False, True):
        with pytest.raises(RuntimeError, match="kernel failed"):
            flag_measurement_set(port, patch_size=8, streaming=streaming, device="cpu")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="model8"):
        flag_measurement_set(port, method="model8", device="cpu")
    with pytest.raises(ValueError, match="predictor"):
        flag_measurement_set(port, method="model", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flag_measurement_set(port)


def test_timings_cover_the_stages():
    port, _ = _both_ms(ntime=16)
    timings = {}
    flag_measurement_set(port, patch_size=16, device="cpu", timings=timings)
    assert set(timings) == {"load", "to_card", "card", "to_host", "save"}
    assert all(v >= 0 for v in timings.values())


@pytest.fixture(scope="module")
def model_ms():
    return _both_ms(spws=(64, 64), ntime=128, seed=5)


def _agree(port, ref):
    got, want = _flag_column(port), _flag_column(ref)
    return float((got == want).mean()), got


@pytest.mark.parametrize("streaming", [False, True], ids=["bulk", "streaming"])
def test_model_matches_jax(model_ms, streaming):
    path = "pretrained/unet16_synthetic.npz"
    port, ref = (ms.copy() for ms in model_ms)
    got = flag_measurement_set(port, method="model", streaming=streaming, device="cpu",
                               predictor=CompiledPredictor.from_snapshot(
                                   path, batch_size=16, device="cpu"))
    want = jax_flag_ms(ref, method="model", streaming=streaming,
                       predictor=JaxPredictor.from_snapshot(path, batch_size=16))
    agree, flags = _agree(port, ref)
    assert agree >= MASK_AGREE, agree
    assert got["baselines"] == want["baselines"] == 3
    assert got["flagged_fraction"] == pytest.approx(want["flagged_fraction"], abs=1e-3)
    assert flags.any()


def test_model8_matches_jax(model_ms):
    path = "pretrained/unet16gn_coherent8ch.npz"
    port, ref = (ms.copy() for ms in model_ms)
    got = flag_measurement_set(port, method="model8", device="cpu",
                               predictor=CompiledPredictor.from_snapshot(
                                   path, batch_size=4, device="cpu"))
    want = jax_flag_ms(ref, method="model8",
                       predictor=JaxPredictor.from_snapshot(path, batch_size=4))
    agree, flags = _agree(port, ref)
    assert agree >= MASK_AGREE, agree
    assert got["baselines"] == want["baselines"] == 3
    assert got["flagged_fraction"] == pytest.approx(want["flagged_fraction"], abs=1e-3)
    assert flags.any()
    ld = MSLoader(port)
    ld.load()
    col = ld.load_flags()
    assert (col == col[:, :1]).all()  # one mask a baseline, on all 4 pols


@pytest.mark.parametrize("normalization",
                         ["global_min_max", "standardize", "robust_scale", None])
def test_rfi_mask_dataset_matches_jax(tmp_path, normalization):
    port, ref = _both_ms(n_ant=4, spws=(16, 16), ntime=24, seed=9)
    ds = RFIMaskDataset(tmp_path / "port", normalization=normalization, use_ms=True,
                        ms_name=port, device="cpu")
    jds = JaxMaskDataset(str(tmp_path / "jax"), normalization=normalization, use_ms=True,
                         ms_name=ref)
    assert len(ds) == len(jds) == 6
    assert ds.antenna_baseline_map == jds.antenna_baseline_map
    for k in ("global_min", "global_max", "mean", "std", "robust_median", "robust_iqr"):
        assert getattr(ds, k) == getattr(jds, k), k
    for i in range(len(ds)):
        x, mask = ds[i]
        jx, jmask = jds[i]
        assert x.dtype == mask.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        assert x.shape == (8, 32, 24) and mask.shape == (1, 32, 24)
    # the directories written, read again without the MS
    again = RFIMaskDataset(tmp_path / "port", normalization=normalization, device="cpu")
    np.testing.assert_array_equal(again[5][0].numpy(), jds[5][0])


def test_rfi_mask_dataset_fields_and_transform(tmp_path):
    kw = dict(num_antennas=3, channels_per_spw=(8,), num_times=6, seed=3)
    ds = RFIMaskDataset(tmp_path / "p", use_ms=True, ms_name=make_fake_ms(**kw),
                        field_selection=0, device="cpu",
                        transform=lambda x, m: (x.flip(-1), m))
    jds = JaxMaskDataset(str(tmp_path / "j"), use_ms=True, ms_name=jax_make_fake_ms(**kw),
                         field_selection=0, transform=lambda x, m: (x[..., ::-1], m))
    assert len(ds) == len(jds) == 3
    np.testing.assert_array_equal(ds[1][0].numpy(), jds[1][0])

    # one field of a two-field MS: the port loads field 2's integrations;
    # JAX's loader counts both fields' and raises
    two = dict(kw, field_ids=(0, 2))
    ds = RFIMaskDataset(tmp_path / "f", use_ms=True, ms_name=make_fake_ms(**two),
                        field_selection=[2], normalization=None, device="cpu")
    want = MSLoader(make_fake_ms(**two), field_id=2).load()
    np.testing.assert_array_equal(ds[1][0][2].numpy(), want[1, 1].real.astype(np.float32))
    with pytest.raises(ValueError, match="expected 12"):
        JaxMaskDataset(str(tmp_path / "g"), use_ms=True, ms_name=jax_make_fake_ms(**two),
                       field_selection=[2])
    with pytest.raises(ValueError, match="ms_name"):
        RFIMaskDataset(tmp_path, use_ms=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RFIMaskDataset(tmp_path / "p")
