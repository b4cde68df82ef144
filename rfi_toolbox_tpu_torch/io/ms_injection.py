"""MS data injection: replace the DATA column with synthetic visibilities.

A copy of ``rfi_toolbox_tpu/io/ms_injection.py`` (the port keeps its
own; it is numpy only). ``inject_synthetic_data`` copies a template MS
(or modifies it in place), infers the baseline map from the baseline
count by the inverse triangular number, splits the channels across SPWs
or replicates them to every SPW, shape-sniffs the stored DATA cells
(pol/chan order, transposed and trailing-singleton layouts), and falls
back to per-row ``putcell`` when the bulk ``putcol`` fails.

Works against casatools paths and the port's in-memory
:class:`~rfi_toolbox_tpu_torch.io.fake_ms.FakeMS`.
"""

import shutil
from pathlib import Path

import numpy as np

from .ms_loader import _is_fake, _open_main, _open_sub

__all__ = ["inject_synthetic_data"]


def inject_synthetic_data(
    template_ms_path,
    synthetic_data,
    output_ms_path=None,
    baseline_map=None,
    num_antennas=None,
):
    """Inject synthetic visibility data into a measurement set.

    Args:
        template_ms_path: existing MS path or FakeMS to use as template.
        synthetic_data: complex array (baselines, pols, channels, times).
        output_ms_path: output MS path (ignored for FakeMS: a copy is
            returned unless the template *is* the output). Default:
            template stem + '.synthetic.ms'.
        baseline_map: list of (ant1, ant2) matching data order.
        num_antennas: antennas (inferred from baseline count otherwise).

    Returns:
        The output MS (path, or the injected FakeMS instance).
    """
    if _is_fake(template_ms_path):
        output = (
            template_ms_path
            if output_ms_path is template_ms_path
            else template_ms_path.copy()
        )
    else:
        template_ms_path = Path(template_ms_path)
        if output_ms_path is None:
            output_ms_path = (
                template_ms_path.parent / f"{template_ms_path.stem}.synthetic.ms"
            )
        else:
            output_ms_path = Path(output_ms_path)
        if template_ms_path.resolve() != output_ms_path.resolve():
            if output_ms_path.exists():
                shutil.rmtree(output_ms_path)
            shutil.copytree(template_ms_path, output_ms_path)
        output = output_ms_path

    synthetic_data = np.asarray(synthetic_data)
    num_baselines, num_pols, num_channels, num_times = synthetic_data.shape

    if baseline_map is None:
        if num_antennas is None:
            # inverse triangular number
            num_antennas = int((1 + np.sqrt(1 + 8 * num_baselines)) / 2)
        baseline_map = []
        for i in range(num_antennas):
            for j in range(i + 1, num_antennas):
                baseline_map.append((i, j))
                if len(baseline_map) >= num_baselines:
                    break
            if len(baseline_map) >= num_baselines:
                break

    tb = _open_main(output, nomodify=False)
    tb_spw = _open_sub(output, "SPECTRAL_WINDOW")
    channels_per_spw = np.asarray(tb_spw.getcol("NUM_CHAN"))
    num_spw = tb_spw.nrows()
    tb_spw.close()

    channels_in_spw = int(channels_per_spw[0])
    if num_channels == channels_in_spw * num_spw:
        split_spws = True
    elif num_channels == channels_in_spw:
        split_spws = False
    else:
        tb.close()
        raise ValueError(
            f"Channel mismatch: data has {num_channels} channels, "
            f"MS SPW has {channels_in_spw} channels"
        )

    for baseline_idx, (ant1, ant2) in enumerate(baseline_map):
        baseline_data = synthetic_data[baseline_idx]  # (pols, chan, times)
        for spw_idx in range(num_spw):
            subtable = tb.query(
                f"DATA_DESC_ID=={spw_idx} && ANTENNA1=={ant1} && ANTENNA2=={ant2}"
            )
            nrows = subtable.nrows()
            if nrows == 0:
                subtable.close()
                continue

            if split_spws:
                start = spw_idx * channels_in_spw
                spw_data = baseline_data[:, start : start + channels_in_spw, :]
            else:
                spw_data = baseline_data

            if spw_data.shape[2] != nrows:
                subtable.close()
                tb.close()
                raise ValueError(
                    f"Time mismatch for baseline ({ant1},{ant2}), SPW "
                    f"{spw_idx}: data times={spw_data.shape[2]} but MS has "
                    f"{nrows} rows"
                )

            # Shape-sniff the existing DATA layout.
            try:
                existing = subtable.getcol("DATA")
            except Exception as e:
                subtable.close()
                tb.close()
                raise RuntimeError(
                    "Unable to read DATA column with getcol; MS may have "
                    f"non-uniform row shapes. Aborting injection. (error: {e})"
                ) from e

            # casacore getcol puts the row axis LAST; search from the
            # end so square cells (nchan == nrows) resolve correctly
            # (the reference searches from the front and mis-injects
            # transposed data in that case)
            row_axis = None
            for ax in reversed(range(existing.ndim)):
                if existing.shape[ax] == nrows:
                    row_axis = ax
                    break
            if row_axis is None:
                subtable.close()
                tb.close()
                raise RuntimeError(
                    f"Unexpected DATA column shape {existing.shape}; cannot "
                    f"find rows axis matching {nrows}"
                )

            other_axes = [i for i in range(existing.ndim) if i != row_axis]
            if len(other_axes) < 2:
                subtable.close()
                tb.close()
                raise RuntimeError(
                    f"DATA column has unexpected ndim {existing.ndim}"
                )
            ax_pol, ax_chan = other_axes[0], other_axes[1]
            # against this SPW's channel count: with split SPWs the data's
            # total count never matches a transposed cell (JAX compares
            # the total, and raises on such an MS)
            transpose = (
                existing.shape[ax_pol] == spw_data.shape[1]
                and existing.shape[ax_chan] == num_pols
            )

            cell_dtype = existing.dtype
            new_col = np.empty_like(existing)
            for t in range(nrows):
                cell = spw_data[:, :, t]
                if transpose:
                    cell = cell.T
                idx = [slice(None)] * existing.ndim
                idx[row_axis] = t
                dest = new_col[tuple(idx)]
                if dest.ndim == 2:
                    dest[:] = cell.astype(cell_dtype)
                elif dest.ndim == 3 and dest.shape[2] == 1:
                    dest[:, :, 0] = cell.astype(cell_dtype)
                else:
                    subtable.close()
                    tb.close()
                    raise RuntimeError(
                        f"Unsupported per-row DATA cell shape: {dest.shape}"
                    )

            try:
                subtable.putcol("DATA", new_col)
            except Exception:
                # per-row fallback
                for row_idx in range(nrows):
                    idx = [slice(None)] * existing.ndim
                    idx[row_axis] = row_idx
                    try:
                        subtable.putcell("DATA", row_idx, new_col[tuple(idx)])
                    except Exception as e:
                        subtable.close()
                        tb.close()
                        raise RuntimeError(
                            f"Failed to write DATA row {row_idx}: {e}"
                        ) from e
            subtable.close()

    tb.close()
    return output
