"""In-memory Measurement Set for tests and CASA-free operation.

A copy of ``rfi_toolbox_tpu/io/fake_ms.py`` (the port keeps its own). It
implements the subset of the casatools ``table`` API that the loader
stack uses: ``open/close/nrows/getcol/putcol/putcell/query/getdminfo``
and row indexing, with casacore's column layout (cell axes first, the
row axis last) and TaQL queries of the form
``DATA_DESC_ID==s && ANTENNA1==i && ANTENNA2==j [&& FIELD_ID==f]``. So
:class:`~rfi_toolbox_tpu_torch.io.ms_loader.MSLoader`,
``inject_synthetic_data`` and ``save_flags`` run unchanged against it.

For the same arguments it holds the same rows and, with a ``seed``, the
same DATA as the JAX package's ``FakeMS`` (one numpy stream, drawn row
by row in the same order).
"""

import copy
import operator
import re

import numpy as np

__all__ = ["FakeMS", "FakeTable", "make_fake_ms"]

_CLAUSE_RE = re.compile(r"\s*(\w+)\s*==\s*(-?\d+)\s*")
_CELL_COLUMNS = ("DATA", "CORRECTED_DATA", "FLAG")


class FakeTable:
    """casatools.table-compatible view over FakeMS rows."""

    def __init__(self, ms, row_indices=None, subtable=None):
        self._ms = ms
        self._sub = subtable
        if subtable is None:
            self._rows = (
                np.arange(len(ms.rows)) if row_indices is None else row_indices
            )
        else:
            self._rows = None

    # -- lifecycle (no-ops; state lives in the FakeMS) --------------------
    def open(self, *a, **k):
        return True

    def close(self):
        return True

    def nrows(self):
        if self._sub is not None:
            return len(self._ms.subtables[self._sub]["rows"])
        return len(self._rows)

    # -- columns ----------------------------------------------------------
    def getcol(self, col):
        if self._sub is not None:
            rows = self._ms.subtables[self._sub]["rows"]
            return np.asarray([r[col] for r in rows])
        vals = [self._ms.rows[i][col] for i in self._rows]
        if col in _CELL_COLUMNS:
            # casacore layout: cell dims first, row axis LAST
            return np.stack(vals, axis=-1)
        return np.asarray(vals)

    def putcol(self, col, arr):
        if self._sub is not None:
            raise ValueError("putcol on subtables not supported")
        arr = np.asarray(arr)
        n = len(self._rows)
        if arr.shape[-1] != n:
            raise ValueError(f"putcol: row axis {arr.shape[-1]} != {n} rows")
        for k, i in enumerate(self._rows):
            self._ms.rows[i][col] = np.array(arr[..., k])

    def putcell(self, col, row, val):
        self._ms.rows[self._rows[row]][col] = np.array(val)

    def __getitem__(self, row_num):
        return self._ms.rows[self._rows[row_num]]

    # -- queries ----------------------------------------------------------
    def query(self, taql):
        """Conjunctions of ``<COL>==<int>`` clauses, the only form the
        loader stack emits. One pass over the rows, each tested by one
        ``itemgetter`` call (a VLA-sized scan has ~90 000 rows, and
        injection queries it once a baseline and SPW)."""
        conditions = {}
        for clause in taql.split("&&"):
            m = _CLAUSE_RE.fullmatch(clause)
            if not m:
                raise ValueError(f"FakeMS cannot parse TaQL clause: {clause!r}")
            conditions[m.group(1)] = int(m.group(2))
        get = operator.itemgetter(*conditions)
        want = tuple(conditions.values())
        if len(want) == 1:
            want = want[0]
        rows = self._ms.rows
        if self._rows is None:
            sel = [i for i, r in enumerate(rows) if get(r) == want]
        else:
            sel = [i for i in self._rows if get(rows[i]) == want]
        return FakeTable(self._ms, np.asarray(sel, dtype=int))

    def getdminfo(self):
        # CellShape reports the STORED per-row cell shape, layout and all,
        # as casacore's hypercube spec records it (the loader derives
        # npol/nchan from it)
        npol, nchan = self._ms.num_pols, int(self._ms.channels_per_spw[0])
        cell = self._ms._to_layout(np.empty((npol, nchan), np.int8))
        return {
            "*1": {
                "COLUMNS": ["DATA", "FLAG"],
                "SPEC": {
                    "HYPERCUBES": {"*1": {"CellShape": np.array(cell.shape)}}
                },
            }
        }


class FakeMS:
    """In-memory measurement set.

    Args:
        num_antennas: antennas in the ANTENNA subtable.
        channels_per_spw: list of channel counts, one per SPW.
        num_times: integrations per (baseline, spw, field).
        num_pols: polarization count (default 4).
        field_ids: list of FIELD_IDs present (default [0]).
        seed: if not None, fill DATA with seeded complex noise; None
            leaves it zero.
        skip_baselines: optional set of (ant1, ant2) pairs with no rows
            (the loader's baseline-skipping path).
        cell_layout: per-row cell orientation of DATA/FLAG columns, one
            of the three a real MS may hold: ``"pol_chan"`` (casacore
            default, (npol, nchan)), ``"chan_pol"`` (transposed, (nchan,
            npol)), ``"pol_chan_1"`` ((npol, nchan, 1)).

    Rows are baseline-major: field, SPW, ANTENNA1, ANTENNA2, then time.
    """

    def __init__(
        self,
        num_antennas=4,
        channels_per_spw=(8,),
        num_times=16,
        num_pols=4,
        field_ids=(0,),
        seed=0,
        skip_baselines=(),
        cell_layout="pol_chan",
    ):
        self.num_antennas = num_antennas
        self.channels_per_spw = np.asarray(channels_per_spw, dtype=int)
        self.num_times = num_times
        self.num_pols = num_pols
        self.field_ids = list(field_ids)
        if cell_layout not in ("pol_chan", "chan_pol", "pol_chan_1"):
            raise ValueError(f"unknown cell_layout {cell_layout!r}")
        self.cell_layout = cell_layout
        rng = np.random.default_rng(seed) if seed is not None else None
        skip = {tuple(sorted(b)) for b in skip_baselines}

        self.subtables = {
            "ANTENNA": {"rows": [{"NAME": f"ant{i}"} for i in range(num_antennas)]},
            "SPECTRAL_WINDOW": {
                "rows": [{"NUM_CHAN": int(nc)} for nc in self.channels_per_spw]
            },
        }

        self.rows = []
        t0 = 5e9
        for field in self.field_ids:
            for spw, nchan in enumerate(self.channels_per_spw):
                for a1 in range(num_antennas):
                    for a2 in range(a1 + 1, num_antennas):
                        if (a1, a2) in skip:
                            continue
                        for t in range(num_times):
                            if rng is not None:
                                data = (
                                    rng.normal(size=(num_pols, nchan))
                                    + 1j * rng.normal(size=(num_pols, nchan))
                                ).astype(np.complex128)
                            else:
                                data = np.zeros((num_pols, nchan), np.complex128)
                            data = self._to_layout(data)
                            self.rows.append(
                                {
                                    "DATA_DESC_ID": spw,
                                    "ANTENNA1": a1,
                                    "ANTENNA2": a2,
                                    "FIELD_ID": field,
                                    "TIME": t0 + t,
                                    "DATA": data,
                                    "CORRECTED_DATA": data.copy(),
                                    "FLAG": self._to_layout(
                                        np.zeros((num_pols, nchan), bool)
                                    ),
                                }
                            )

    def _to_layout(self, cell):
        """Reorient a canonical (npol, nchan) cell into this MS's stored
        cell layout."""
        if self.cell_layout == "chan_pol":
            return cell.T.copy()
        if self.cell_layout == "pol_chan_1":
            return cell[..., None].copy()
        return cell

    def table(self, subtable=None):
        """Open the main table or a subtable ('ANTENNA', 'SPECTRAL_WINDOW')."""
        return FakeTable(self, subtable=subtable)

    def copy(self):
        """Deep copy (``inject_synthetic_data``'s 'copytree')."""
        return copy.deepcopy(self)


def make_fake_ms(
    num_antennas=4,
    channels_per_spw=(8,),
    num_times=16,
    num_pols=4,
    field_ids=(0,),
    seed=0,
    skip_baselines=(),
    cell_layout="pol_chan",
):
    """Convenience constructor of :class:`FakeMS`."""
    return FakeMS(
        num_antennas=num_antennas,
        channels_per_spw=channels_per_spw,
        num_times=num_times,
        num_pols=num_pols,
        field_ids=field_ids,
        seed=seed,
        skip_baselines=skip_baselines,
        cell_layout=cell_layout,
    )
