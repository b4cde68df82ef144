"""MS Loader: complex visibilities of a CASA measurement set.

A copy of ``rfi_toolbox_tpu/io/ms_loader.py`` (the port keeps its own;
it is numpy only). The table backend is casatools (optional, imported
only when a path is opened) for a filesystem path, or the port's
in-memory :class:`~rfi_toolbox_tpu_torch.io.fake_ms.FakeMS`. Loading
returns host numpy arrays, complex128 as the MS stores them; the
flagging path casts them to complex64 once and copies them to the card.

Semantics kept from the reference loader:
- only SPWs whose channel count equals SPW 0's are loaded;
- baselines with zero rows are skipped and left out of
  ``antenna_baseline_map``;
- ``num_antennas`` limits only the ANTENNA1 loop; ANTENNA2 runs over all
  antennas.

``load``/``load_flags``/``save_flags`` issue ONE query and ONE bulk
getcol/putcol per SPW and group the rows into baselines on the host with
a stable sort. The per-baseline API (``load_baseline`` etc.) keeps
targeted single-baseline queries for out-of-core streaming.
"""

import numpy as np

from ..utils.progress import progress
from .fake_ms import FakeMS

__all__ = ["MSLoader"]


def _group_baseline_rows(ant1, ant2, max_ant1=None):
    """Group row indices of one SPW's bulk read into baselines.

    Returns [((a1, a2), row_indices)] sorted ascending by (a1, a2) —
    the same order the reference's nested antenna loops produce — with
    each group's rows in original table order (time order). Rows with
    a1 >= a2 (autocorrelations / reversed) never match the reference's
    queries and are dropped; ``max_ant1`` applies the ANTENNA1-only
    ``num_antennas`` limit.
    """
    ant1 = np.asarray(ant1)
    ant2 = np.asarray(ant2)
    keep = ant2 > ant1
    if max_ant1 is not None:
        keep &= ant1 < max_ant1
    idx = np.nonzero(keep)[0]
    if idx.size == 0:
        return []
    span = int(ant2.max()) + 1
    key = ant1[idx].astype(np.int64) * span + ant2[idx]
    order = np.argsort(key, kind="stable")
    sorted_idx = idx[order]
    sorted_key = key[order]
    cuts = np.nonzero(np.diff(sorted_key))[0] + 1
    segments = np.split(sorted_idx, cuts)
    return [
        ((int(ant1[seg[0]]), int(ant2[seg[0]])), seg) for seg in segments
    ]


def _canonicalize_cells(col, num_channels):
    """Reorient a bulk getcol result (casacore row axis LAST) into the
    canonical (num_pols, num_channels, nrows) layout, whatever the
    stored per-row cell orientation.

    Real MSes are not uniform here: transposed (nchan, npol) and
    trailing-singleton (npol, nchan, 1) cells occur in the wild — the
    reason the injection path shape-sniffs before writing. The
    reference's *loader* assumes (npol, nchan) and silently swaps the
    pol/chan axes on a transposed MS; this loader normalizes on read
    instead. The SPECTRAL_WINDOW table's NUM_CHAN is
    the ground truth that picks the channel axis; square cells
    (npol == nchan) are inherently ambiguous and keep the casacore
    default (npol, nchan) orientation, matching the reference.

    Returns ``(canonical, restore)`` where ``restore(arr)`` maps a
    canonical (num_pols, num_channels, nrows) array back to the stored
    layout for putcol (read-modify-write flag saves).
    """
    col = np.asarray(col)
    squeezed = transposed = False
    if col.ndim == 4:
        if col.shape[2] != 1:
            raise ValueError(
                f"unsupported DATA/FLAG column shape {col.shape}"
            )
        squeezed = True
        col = col[:, :, 0, :]
    if col.ndim != 3:
        raise ValueError(f"unsupported DATA/FLAG column shape {col.shape}")
    if col.shape[0] == num_channels and col.shape[1] != num_channels:
        transposed = True
        col = col.swapaxes(0, 1)

    def restore(canonical):
        out = np.asarray(canonical)
        if transposed:
            out = out.swapaxes(0, 1)
        if squeezed:
            out = out[:, :, None, :]
        return np.ascontiguousarray(out)

    return col, restore


def _is_fake(ms):
    return isinstance(ms, FakeMS)


def _open_main(ms, nomodify=True):
    if _is_fake(ms):
        return ms.table()
    from casatools import table  # noqa: PLC0415  (optional dependency)

    tb = table()
    tb.open(str(ms), nomodify=nomodify)
    return tb


def _open_sub(ms, name):
    if _is_fake(ms):
        return ms.table(name)
    from casatools import table  # noqa: PLC0415

    tb = table()
    tb.open(str(ms) + "/" + name)
    return tb


class MSLoader:
    """Load complex visibilities from CASA measurement sets.

    >>> loader = MSLoader('observation.ms', field_id=0)   # casatools
    >>> loader = MSLoader(make_fake_ms())                  # in-memory
    >>> loader.load(num_antennas=5, mode='DATA')
    >>> data = loader.data          # (baselines, pols, channels, times)
    >>> flags = loader.load_flags()
    """

    def __init__(self, ms_path, field_id=None):
        self.ms_path = ms_path if _is_fake(ms_path) else str(ms_path)
        self.field_id = field_id

        tb = _open_sub(self.ms_path, "ANTENNA")
        self.num_antennas = tb.nrows()
        tb.close()

        tb = _open_sub(self.ms_path, "SPECTRAL_WINDOW")
        self.num_spw = tb.nrows()
        self.channels_per_spw = np.asarray(tb.getcol("NUM_CHAN"))
        tb.close()

        self.tb = _open_main(self.ms_path, nomodify=False)

        field_filter = (
            f" && FIELD_ID=={self.field_id}" if self.field_id is not None else ""
        )
        subtable = self.tb.query(
            f"DATA_DESC_ID==0 && ANTENNA1==0 && ANTENNA2==1{field_filter}"
        )
        self.num_times = len(subtable.getcol("TIME"))
        subtable.close()

        self.data = None
        self.flags = None
        self.antenna_baseline_map = None
        self.spw_list = None
        self.channels_per_spw_list = None

    # -- helpers ----------------------------------------------------------
    def _field_filter(self, field_id=None):
        fid = self.field_id if field_id is None else field_id
        return f" && FIELD_ID=={fid}" if fid is not None else ""

    def _same_spws(self, channels_per_spw=None):
        """SPWs matching SPW 0's channel count."""
        cps = (
            self.channels_per_spw if channels_per_spw is None else channels_per_spw
        )
        same_spw, same_chan = [], []
        for spw, num_chan in enumerate(cps):
            if num_chan == cps[0]:
                same_spw.append(spw)
                same_chan.append(int(num_chan))
        return same_spw, same_chan

    # -- metadata ---------------------------------------------------------
    def get_metadata(self, num_antennas=None, mode="DATA"):
        """MS shape metadata without loading data (dminfo hypercube
        CellShape)."""
        if num_antennas is None:
            num_antennas = self.num_antennas

        dminfo = self.tb.getdminfo()
        data_sm = None
        for _, info in dminfo.items():
            if mode in info.get("COLUMNS", []):
                data_sm = info
                break
        if data_sm is None:
            raise ValueError(f"Column {mode} not found in MS")
        hypercubes = data_sm["SPEC"]["HYPERCUBES"]
        if not hypercubes:
            raise ValueError(f"No hypercube info for {mode}")
        cell_shape = list(hypercubes.values())[0]["CellShape"]
        num_pols, num_channels = int(cell_shape[0]), int(cell_shape[1])
        # Transposed (nchan, npol) cells exist in the wild (see
        # _canonicalize_cells); SPW NUM_CHAN disambiguates the labels.
        nchan0 = int(self.channels_per_spw[0])
        if num_pols == nchan0 and num_channels != nchan0:
            num_pols, num_channels = num_channels, num_pols

        baseline_map = [
            (i, j)
            for i in range(num_antennas)
            for j in range(i + 1, num_antennas)
        ]
        return {
            "num_baselines": len(baseline_map),
            "num_pols": num_pols,
            "num_channels": num_channels,
            "num_times": self.num_times,
            "baseline_map": baseline_map,
            "num_spws": len(self.channels_per_spw),
            "total_channels": int(np.sum(self.channels_per_spw)),
            "channels_per_spw": self.channels_per_spw.tolist(),
            "shape": (
                len(baseline_map),
                num_pols,
                num_channels,
                self.num_times,
            ),
        }

    # -- bulk load --------------------------------------------------------
    def load(self, num_antennas=None, mode="DATA", field_id=None):
        """Load visibilities -> (baselines, pols, total_channels, times)
        complex128.

        The reference's output and semantics, through ONE query and bulk
        getcol per SPW with host-side baseline grouping instead of one
        query per baseline x SPW.
        """
        if num_antennas is None:
            num_antennas = self.num_antennas
        if field_id is not None:
            self.field_id = field_id

        same_spw_list, same_channels_list = self._same_spws()
        num_channels = same_channels_list[0]
        total_channels = len(same_spw_list) * num_channels
        ff = self._field_filter()

        per_spw = []  # (spw_idx, {(a1, a2): (pols, nchan, ntimes)})
        pair_set = set()
        for spw_idx, spw in progress(
            list(enumerate(same_spw_list)), desc="Load SPW"
        ):
            subtable = self.tb.query(f"DATA_DESC_ID=={spw}{ff}")
            if subtable.nrows() == 0:
                subtable.close()
                continue
            ant1 = np.asarray(subtable.getcol("ANTENNA1"))
            ant2 = np.asarray(subtable.getcol("ANTENNA2"))
            vis, _ = _canonicalize_cells(subtable.getcol(mode), num_channels)
            subtable.close()
            spw_map = {}
            for pair, rows in _group_baseline_rows(ant1, ant2, num_antennas):
                if len(rows) != self.num_times:
                    raise ValueError(
                        f"baseline {pair} has {len(rows)} rows in SPW {spw}, "
                        f"expected {self.num_times}"
                    )
                spw_map[pair] = vis[:, :, rows]
            per_spw.append((spw_idx, spw_map))
            pair_set.update(spw_map)

        baseline_map = sorted(pair_set)
        data = np.zeros(
            [len(baseline_map), 4, total_channels, self.num_times],
            dtype="complex128",
        )
        index = {pair: b for b, pair in enumerate(baseline_map)}
        for spw_idx, spw_map in per_spw:
            start = spw_idx * num_channels
            for pair, block in spw_map.items():
                data[index[pair], :, start : start + num_channels, :] = block

        self.data = data
        self.antenna_baseline_map = baseline_map
        self.spw_list = same_spw_list
        self.channels_per_spw_list = same_channels_list
        return self.data

    def load_single_baseline(self, ant1=0, ant2=1, pol_idx=0, mode="DATA",
                             field_id=None):
        """One baseline, one polarization -> (total_channels, times)
       . Raises if the baseline has no rows."""
        if field_id is not None:
            self.field_id = field_id
        same_spw_list, same_channels_list = self._same_spws()
        num_channels = same_channels_list[0]
        total_channels = len(same_spw_list) * num_channels
        ff = self._field_filter()

        baseline_data = np.zeros([total_channels, self.num_times], "complex128")
        for spw_idx, spw in enumerate(same_spw_list):
            subtable = self.tb.query(
                f"DATA_DESC_ID=={spw} && ANTENNA1=={ant1} && ANTENNA2=={ant2}{ff}"
            )
            if subtable.nrows() == 0:
                subtable.close()
                raise ValueError(
                    f"No data for baseline {ant1}-{ant2} in SPW {spw}"
                )
            spw_data, _ = _canonicalize_cells(
                subtable.getcol(mode), num_channels
            )
            start = spw_idx * num_channels
            baseline_data[start : start + num_channels, :] = spw_data[pol_idx]
            subtable.close()
        return baseline_data

    def load_baseline(self, ant1, ant2, mode="DATA", field_id=None):
        """One baseline, all pols; self-contained open/close per call
        for out-of-core streaming."""
        tb = _open_main(self.ms_path, nomodify=False)
        tb_spw = _open_sub(self.ms_path, "SPECTRAL_WINDOW")
        channels_per_spw = np.asarray(tb_spw.getcol("NUM_CHAN"))
        tb_spw.close()

        same_spw_list, same_channels_list = self._same_spws(channels_per_spw)
        num_channels = same_channels_list[0]
        total_channels = len(same_spw_list) * num_channels
        ff = f" && FIELD_ID=={field_id}" if field_id is not None else ""

        test_sub = tb.query(
            f"DATA_DESC_ID=={same_spw_list[0]} && ANTENNA1=={ant1} && "
            f"ANTENNA2=={ant2}{ff}"
        )
        num_times = test_sub.nrows()
        test_sub.close()

        baseline_data = np.zeros([4, total_channels, num_times], "complex128")
        for spw_idx, spw in enumerate(same_spw_list):
            subtable = tb.query(
                f"DATA_DESC_ID=={spw} && ANTENNA1=={ant1} && ANTENNA2=={ant2}{ff}"
            )
            if subtable.nrows() == 0:
                subtable.close()
                continue
            spw_data, _ = _canonicalize_cells(
                subtable.getcol(mode), num_channels
            )
            start = spw_idx * num_channels
            baseline_data[:, start : start + num_channels, :] = spw_data
            subtable.close()
        tb.close()
        return baseline_data

    def load_baseline_flags(self, ant1, ant2, field_id=None):
        """FLAG column for one baseline -> (4, total_channels, times)
        bool; self-contained open/close (companion to load_baseline)."""
        tb = _open_main(self.ms_path, nomodify=False)
        tb_spw = _open_sub(self.ms_path, "SPECTRAL_WINDOW")
        channels_per_spw = np.asarray(tb_spw.getcol("NUM_CHAN"))
        tb_spw.close()

        same_spw_list, same_channels_list = self._same_spws(channels_per_spw)
        num_channels = same_channels_list[0]
        total_channels = len(same_spw_list) * num_channels
        ff = f" && FIELD_ID=={field_id}" if field_id is not None else ""

        test_sub = tb.query(
            f"DATA_DESC_ID=={same_spw_list[0]} && ANTENNA1=={ant1} && "
            f"ANTENNA2=={ant2}{ff}"
        )
        num_times = test_sub.nrows()
        test_sub.close()

        flags = np.zeros([4, total_channels, num_times], dtype=bool)
        for spw_idx, spw in enumerate(same_spw_list):
            subtable = tb.query(
                f"DATA_DESC_ID=={spw} && ANTENNA1=={ant1} && ANTENNA2=={ant2}{ff}"
            )
            if subtable.nrows() == 0:
                subtable.close()
                continue
            start = spw_idx * num_channels
            spw_flags, _ = _canonicalize_cells(
                subtable.getcol("FLAG"), num_channels
            )
            flags[:, start : start + num_channels, :] = spw_flags
            subtable.close()
        tb.close()
        return flags

    def save_baseline_flags(self, ant1, ant2, flags, field_id=None):
        """Write flags for one baseline; self-contained open/close
       ."""
        tb = _open_main(self.ms_path, nomodify=False)
        tb_spw = _open_sub(self.ms_path, "SPECTRAL_WINDOW")
        channels_per_spw = np.asarray(tb_spw.getcol("NUM_CHAN"))
        tb_spw.close()

        same_spw_list, same_channels_list = self._same_spws(channels_per_spw)
        num_channels = same_channels_list[0]
        ff = f" && FIELD_ID=={field_id}" if field_id is not None else ""

        for spw_idx, spw in enumerate(same_spw_list):
            start = spw_idx * num_channels
            spw_flags = flags[:, start : start + num_channels, :]
            subtable = tb.query(
                f"DATA_DESC_ID=={spw} && ANTENNA1=={ant1} && ANTENNA2=={ant2}{ff}"
            )
            if subtable.nrows() > 0:
                _, restore = _canonicalize_cells(
                    subtable.getcol("FLAG"), num_channels
                )
                subtable.putcol(
                    "FLAG", restore(np.asarray(spw_flags, dtype=bool))
                )
            subtable.close()
        tb.close()

    def get_baseline_pairs(self, num_antennas=None):
        """All (ant1 < ant2) pairs."""
        if num_antennas is None:
            num_antennas = self.num_antennas
        return [
            (i, j)
            for i in range(num_antennas)
            for j in range(i + 1, num_antennas)
        ]

    def load_flags(self):
        """FLAG column with the load() layout,
        via one bulk getcol per SPW."""
        if self.antenna_baseline_map is None:
            raise ValueError("Must call load() first to establish baseline map")
        ff = self._field_filter()
        num_channels = self.channels_per_spw_list[0]
        total_channels = len(self.spw_list) * num_channels
        index = {pair: b for b, pair in enumerate(self.antenna_baseline_map)}

        flags = np.zeros(
            [len(self.antenna_baseline_map), 4, total_channels, self.num_times],
            dtype=bool,
        )
        for spw_idx, spw in progress(
            list(enumerate(self.spw_list)), desc="Load flags (SPW)"
        ):
            subtable = self.tb.query(f"DATA_DESC_ID=={spw}{ff}")
            if subtable.nrows() == 0:
                subtable.close()
                continue
            ant1 = np.asarray(subtable.getcol("ANTENNA1"))
            ant2 = np.asarray(subtable.getcol("ANTENNA2"))
            col, _ = _canonicalize_cells(subtable.getcol("FLAG"), num_channels)
            subtable.close()
            start = spw_idx * num_channels
            for pair, rows in _group_baseline_rows(ant1, ant2):
                b = index.get(pair)
                if b is not None:
                    flags[b, :, start : start + num_channels, :] = (
                        col[:, :, rows]
                    )

        self.flags = flags
        return self.flags

    def save_flags(self, flags):
        """Write flags (baselines, pols, channels, times) back to the
        FLAG column.

        One bulk getcol + putcol per SPW (read-modify-write: rows of
        baselines outside the map — autocorrelations, skipped antennas —
        keep their existing flags, exactly as the reference's targeted
        per-baseline putcols would leave them).
        """
        if self.antenna_baseline_map is None:
            raise ValueError("Must call load() first to establish baseline map")
        ff = self._field_filter()
        num_channels = self.channels_per_spw_list[0]
        index = {pair: b for b, pair in enumerate(self.antenna_baseline_map)}
        flags = np.asarray(flags)

        for spw_idx, spw in progress(
            list(enumerate(self.spw_list)), desc="Save flags (SPW)"
        ):
            subtable = self.tb.query(f"DATA_DESC_ID=={spw}{ff}")
            if subtable.nrows() == 0:
                subtable.close()
                continue
            ant1 = np.asarray(subtable.getcol("ANTENNA1"))
            ant2 = np.asarray(subtable.getcol("ANTENNA2"))
            start = spw_idx * num_channels
            col = restore = None
            for pair, rows in _group_baseline_rows(ant1, ant2):
                b = index.get(pair)
                if b is None:
                    continue
                if col is None:
                    col, restore = _canonicalize_cells(
                        subtable.getcol("FLAG"), num_channels
                    )
                    col = np.ascontiguousarray(col)
                col[:, :, rows] = flags[
                    b, :, start : start + num_channels, :
                ].astype(bool)
            if col is not None:
                subtable.putcol("FLAG", restore(col))
            subtable.close()

    def get_available_fields(self):
        """Sorted unique FIELD_IDs."""
        field_ids = np.unique(self.tb.getcol("FIELD_ID"))
        return sorted(int(f) for f in field_ids)

    def close(self):
        """Close the table and drop the loaded arrays. Reference counting
        frees them; JAX's loader also runs ``gc.collect()`` here, which
        costs 0.1 s or more a call in a process holding many objects."""
        if hasattr(self, "tb") and self.tb is not None:
            self.tb.close()
            self.tb = None
        self.data = None
        self.flags = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def magnitude(self):
        """|visibilities|."""
        if self.data is None:
            raise ValueError("Must call load() first")
        return np.abs(self.data)
