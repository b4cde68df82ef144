"""Port parity: the Measurement Set I/O (FakeMS, MSLoader,
inject_synthetic_data) against the JAX package, on the CPU.

The port keeps its own numpy copies of these modules; the same arguments
must build the same MS, and every load, save and injection must leave
both packages' MSes and arrays bit-equal. The port's FakeMS is also held
to the recorded casacore contract (tests/golden/casacore_contract.json)."""

import json
from pathlib import Path

import numpy as np
import pytest

from rfi_toolbox_tpu.io import MSLoader as JaxLoader
from rfi_toolbox_tpu.io import inject_synthetic_data as jax_inject
from rfi_toolbox_tpu.io import make_fake_ms as jax_make_fake_ms
from rfi_toolbox_tpu_torch.io import (
    CASA_AVAILABLE,
    FakeMS,
    MSLoader,
    inject_synthetic_data,
    make_fake_ms,
)

CONTRACT = json.loads(
    (Path(__file__).parent / "golden" / "casacore_contract.json").read_text())
LAYOUTS = ("pol_chan", "chan_pol", "pol_chan_1")

CASES = {
    "two spws": dict(num_antennas=4, channels_per_spw=(8, 8), num_times=5, seed=1),
    "unequal spws": dict(num_antennas=3, channels_per_spw=(8, 4, 8), num_times=4, seed=2),
    "skip": dict(num_antennas=4, channels_per_spw=(8, 8), num_times=4, seed=3,
                 skip_baselines=[(1, 2), (0, 3)]),
    "fields": dict(num_antennas=3, channels_per_spw=(6,), num_times=4, seed=4,
                   field_ids=(0, 2)),
    **{layout: dict(num_antennas=3, channels_per_spw=(8, 8), num_times=5, seed=7,
                    cell_layout=layout) for layout in LAYOUTS},
    "zeros": dict(num_antennas=3, channels_per_spw=(4,), num_times=3, seed=None),
}


def _both(**kw):
    return make_fake_ms(**kw), jax_make_fake_ms(**kw)


def _assert_same_ms(port, ref):
    assert len(port.rows) == len(ref.rows)
    for a, b in zip(port.rows, ref.rows):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    assert port.subtables == ref.subtables


def _time_major(ms):
    ms.rows.sort(key=lambda r: (r["FIELD_ID"], r["DATA_DESC_ID"], r["TIME"],
                                r["ANTENNA1"], r["ANTENNA2"]))


@pytest.mark.parametrize("case", list(CASES))
def test_fake_ms_equals_jax(case):
    port, ref = _both(**CASES[case])
    _assert_same_ms(port, ref)
    tb, jtb = port.table(), ref.table()
    spw0, jspw0 = tb.query("DATA_DESC_ID==0"), jtb.query("DATA_DESC_ID==0")
    for col in ("DATA", "FLAG"):
        np.testing.assert_array_equal(spw0.getcol(col), jspw0.getcol(col))
    for col in ("ANTENNA1", "TIME"):
        np.testing.assert_array_equal(tb.getcol(col), jtb.getcol(col))
    assert str(tb.getdminfo()) == str(jtb.getdminfo())
    for q in ("DATA_DESC_ID==0 && ANTENNA1==0 && ANTENNA2==2",
              "ANTENNA2==2", " FIELD_ID == 0 &&DATA_DESC_ID==0 "):
        np.testing.assert_array_equal(tb.query(q)._rows, jtb.query(q)._rows)
    sub = tb.query("DATA_DESC_ID==0")  # a query of a query
    np.testing.assert_array_equal(sub.query("ANTENNA1==1")._rows,
                                  jtb.query("DATA_DESC_ID==0").query("ANTENNA1==1")._rows)
    with pytest.raises(ValueError, match="TaQL"):
        tb.query("ANTENNA1 > 1")


@pytest.mark.parametrize("time_major", [False, True], ids=["baseline-major", "time-major"])
@pytest.mark.parametrize("case", list(CASES))
def test_loader_matches_jax(case, time_major):
    """load, load_flags, save_flags, the per-baseline calls and the
    metadata: equal arrays, maps and MSes after every write."""
    port, ref = _both(**CASES[case])
    if time_major:
        _time_major(port)
        _time_major(ref)
    field = 2 if case == "fields" else None
    ld, jld = MSLoader(port, field_id=field), JaxLoader(ref, field_id=field)
    assert ld.get_metadata() == jld.get_metadata()
    assert ld.get_available_fields() == jld.get_available_fields()
    assert ld.get_baseline_pairs(3) == jld.get_baseline_pairs(3)

    data = ld.load()
    np.testing.assert_array_equal(data, jld.load())
    assert data.dtype == np.complex128
    assert ld.antenna_baseline_map == jld.antenna_baseline_map
    assert ld.spw_list == jld.spw_list and ld.num_times == jld.num_times
    np.testing.assert_array_equal(ld.magnitude, jld.magnitude)
    flags = ld.load_flags()
    np.testing.assert_array_equal(flags, jld.load_flags())

    new = np.random.default_rng(11).random(flags.shape) > 0.6
    ld.save_flags(new)
    jld.save_flags(new)
    _assert_same_ms(port, ref)
    np.testing.assert_array_equal(ld.load_flags(), new)

    a1, a2 = ld.antenna_baseline_map[-1]
    np.testing.assert_array_equal(ld.load_baseline(a1, a2, field_id=field),
                                  jld.load_baseline(a1, a2, field_id=field))
    np.testing.assert_array_equal(ld.load_single_baseline(a1, a2, pol_idx=2),
                                  jld.load_single_baseline(a1, a2, pol_idx=2))
    blf = ~ld.load_baseline_flags(a1, a2, field_id=field)
    np.testing.assert_array_equal(blf, ~jld.load_baseline_flags(a1, a2, field_id=field))
    ld.save_baseline_flags(a1, a2, blf, field_id=field)
    jld.save_baseline_flags(a1, a2, blf, field_id=field)
    _assert_same_ms(port, ref)
    ld.close()
    jld.close()


def test_num_antennas_limits_antenna1_only():
    port, ref = _both(num_antennas=5, channels_per_spw=(4,), num_times=3, seed=5)
    ld, jld = MSLoader(port), JaxLoader(ref)
    np.testing.assert_array_equal(ld.load(num_antennas=2), jld.load(num_antennas=2))
    assert ld.antenna_baseline_map == jld.antenna_baseline_map == [
        (0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4)]
    assert ld.get_metadata(num_antennas=2) == jld.get_metadata(num_antennas=2)


def test_loader_errors_match_jax():
    port, ref = _both(num_antennas=3, num_times=4)
    for ld in (MSLoader(port), JaxLoader(ref)):
        with pytest.raises(ValueError, match="load"):
            ld.load_flags()
        with pytest.raises(ValueError, match="load"):
            ld.save_flags(np.zeros((3, 4, 8, 4), bool))
        with pytest.raises(ValueError, match="load"):
            _ = ld.magnitude
        with pytest.raises(ValueError, match="not found"):
            ld.get_metadata(mode="MODEL_DATA")
    port.rows = [r for r in port.rows
                 if not (r["ANTENNA1"] == 1 and r["TIME"] >= 5e9 + 3)]  # ragged
    with pytest.raises(ValueError, match="expected 4"):
        MSLoader(port).load()
    with pytest.raises(ValueError, match="No data"):
        MSLoader(make_fake_ms(num_antennas=3, skip_baselines=[(0, 2)])).load_single_baseline(0, 2)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("split", [True, False], ids=["split", "replicated"])
def test_injection_matches_jax(layout, split):
    kw = dict(num_antennas=4, channels_per_spw=(8, 8), num_times=5, seed=6,
              cell_layout=layout, skip_baselines=[(0, 2)])
    port, ref = _both(**kw)
    rng = np.random.default_rng(8)
    shape = (6, 4, 16 if split else 8, 5)
    vis = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    out = inject_synthetic_data(port, vis)
    assert isinstance(out, FakeMS) and out is not port  # a copy: template unchanged
    _assert_same_ms(port, ref)
    loaded = MSLoader(out).load()
    want = vis if split else np.concatenate([vis, vis], axis=2)
    # (0, 2) has no rows: its block is skipped, the map is the first 6 pairs
    keep = [0, 2, 3, 4, 5]
    np.testing.assert_array_equal(loaded, want[keep])
    same = inject_synthetic_data(port, vis, output_ms_path=port)  # in place
    assert same is port
    _assert_same_ms(port, out)
    if split and layout == "chan_pol":
        # JAX sniffs a transposed cell against the data's 16 channels,
        # not the SPW's 8, and fails to write it
        with pytest.raises(ValueError, match="broadcast"):
            jax_inject(ref, vis)
        return
    _assert_same_ms(out, jax_inject(ref, vis))
    assert jax_inject(ref, vis, output_ms_path=ref) is ref
    _assert_same_ms(port, ref)


def test_injection_options_and_errors_match_jax():
    port, ref = _both(num_antennas=4, channels_per_spw=(8,), num_times=4, seed=9)
    vis = np.full((2, 4, 8, 4), 3 - 1j)
    bmap = [(1, 3), (0, 2)]
    _assert_same_ms(inject_synthetic_data(port, vis, baseline_map=bmap),
                    jax_inject(ref, vis, baseline_map=bmap))
    _assert_same_ms(inject_synthetic_data(port, vis, num_antennas=3),
                    jax_inject(ref, vis, num_antennas=3))
    with pytest.raises(ValueError, match="Channel mismatch"):
        inject_synthetic_data(port, np.zeros((3, 4, 12, 4), complex))
    with pytest.raises(ValueError, match="Time mismatch"):
        inject_synthetic_data(port, np.zeros((3, 4, 8, 5), complex))


def test_injection_falls_back_to_putcell(monkeypatch):
    """A table whose bulk putcol fails is written row by row."""
    from rfi_toolbox_tpu_torch.io import fake_ms

    port = make_fake_ms(num_antennas=3, channels_per_spw=(8,), num_times=4, seed=None)
    vis = np.arange(3 * 4 * 8 * 4).reshape(3, 4, 8, 4) * (1 + 1j)

    def refuse(self, col, arr):
        raise RuntimeError("non-uniform column")

    monkeypatch.setattr(fake_ms.FakeTable, "putcol", refuse)
    inject_synthetic_data(port, vis, output_ms_path=port)
    monkeypatch.undo()
    np.testing.assert_array_equal(MSLoader(port).load(), vis)


# -- the casacore contract, as tests/test_casacore_contract.py holds the
# -- JAX package's FakeMS to it

def _contract_ms(**kw):
    cfg = CONTRACT["config"]
    return FakeMS(num_antennas=cfg["num_antennas"],
                  channels_per_spw=tuple(cfg["channels_per_spw"]),
                  num_times=cfg["num_times"], num_pols=cfg["num_pols"], seed=0, **kw)


def test_contract_getcol_putcol_and_cells():
    want = CONTRACT["main_table"]
    ms = _contract_ms()
    tb = ms.table()
    assert tb.nrows() == want["nrows"]
    data = tb.getcol("DATA")
    assert list(data.shape) == want["DATA_shape"] and data.dtype.kind == "c"
    flags = tb.getcol("FLAG")
    assert list(flags.shape) == want["FLAG_shape"]
    assert flags.dtype.kind == want["FLAG_dtype_kind"]
    assert list(np.shape(tb.getcol("ANTENNA1"))) == want["ANTENNA1_shape"]
    for k in range(tb.nrows()):  # row k's cell surfaces at [..., k]
        tb.putcell("DATA", k, np.full(tuple(CONTRACT["getdminfo_cell_shape"]), k + 1,
                                      np.complex128))
    data = tb.getcol("DATA")
    for k in range(tb.nrows()):
        np.testing.assert_array_equal(np.take(data, k, axis=want["row_axis"]).real, k + 1)
    npol, nchan = CONTRACT["getdminfo_cell_shape"]
    new = np.zeros((npol, nchan, tb.nrows()), bool)
    new[..., 1] = True
    tb.putcol("FLAG", new)
    np.testing.assert_array_equal(tb.getcol("FLAG"), new)
    assert ms.rows[1]["FLAG"].all() and not ms.rows[0]["FLAG"].any()
    with pytest.raises(ValueError, match="row axis"):
        tb.putcol("FLAG", np.zeros((tb.nrows(), npol, nchan), bool))
    hyper = next(iter(tb.getdminfo().values()))["SPEC"]["HYPERCUBES"]
    assert list(next(iter(hyper.values()))["CellShape"]) == CONTRACT["getdminfo_cell_shape"]
    subs = CONTRACT["subtables"]
    assert list(np.shape(ms.table("SPECTRAL_WINDOW").getcol("NUM_CHAN"))) == \
        subs["SPECTRAL_WINDOW"]["NUM_CHAN_shape"]
    assert list(np.shape(ms.table("ANTENNA").getcol("NAME"))) == subs["ANTENNA"]["NAME_shape"]
    with pytest.raises(ValueError, match="subtables"):
        ms.table("ANTENNA").putcol("NAME", np.zeros(2))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_contract_cell_layouts(layout):
    want = CONTRACT["cell_layouts"][layout]
    ms = _contract_ms(cell_layout=layout)
    assert list(ms.rows[0]["DATA"].shape) == want["cell_shape"]
    tb = ms.table()
    assert list(tb.getcol("DATA").shape) == want["getcol_shape"]
    hyper = next(iter(tb.getdminfo().values()))["SPEC"]["HYPERCUBES"]
    assert list(next(iter(hyper.values()))["CellShape"]) == want["cell_shape"]
    meta = MSLoader(ms).get_metadata()
    assert (meta["num_pols"], meta["num_channels"]) == tuple(CONTRACT["getdminfo_cell_shape"])
    with pytest.raises(ValueError, match="cell_layout"):
        FakeMS(cell_layout="chan_pol_2")


def test_casatools_stays_optional():
    """No casatools here: the package imports, and a path (not a FakeMS)
    reaches the lazy casatools import."""
    if CASA_AVAILABLE:
        pytest.skip("this machine has casatools")
    with pytest.raises(ImportError, match="casatools"):
        MSLoader("observation.ms")
