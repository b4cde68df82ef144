"""Waterfall and measurement-set flagging on the card.

Counterpart of ``rfi_toolbox_tpu/io/flagging.py``:

- ``flag_waterfalls`` (``method="mad"`` and ``method="model"``): patchify
  -> MAD flags (kernel K5) or 3-channel extraction (kernel K4) and a
  predictor -> unpatchify;
- ``flag_waterfalls_coherent``: the coherent 8-channel convention, all
  four polarisations of a baseline through one 8-channel model, one mask
  a baseline;
- ``flag_measurement_set``: a whole Measurement Set, loaded on the host
  (``MSLoader``), flagged on the card and written back to its FLAG
  column, in bulk or baseline by baseline with a prefetch thread.

Each step runs in a program span (``utils.profiling.span``):
``flag.call`` around a ``flag_waterfalls`` call, with ``flag.patchify``,
``flag.mad``, ``flag.extract``, ``flag.predict`` and ``flag.unpatchify``
inside it; ``coherent.call`` around a ``flag_waterfalls_coherent`` call,
with ``coherent.images`` (``coherent_images``: patchify, ``to_8ch`` and
the robust scale, ``coherent.scale``, inside it), ``coherent.predict``
and ``coherent.unpatchify`` inside it; ``ms.load``, ``ms.to_card``,
``ms.card``, ``ms.to_host`` and ``ms.save`` around
``flag_measurement_set``'s stages, whose host durations fill its
``timings=``.

Complex visibilities go to the card as complex64 as they are (JAX stages
them as two real planes for TPU runtimes that cannot copy complex types;
the card can). With a mesh (``mesh=``; one process a device) each rank
flags its waterfalls, or its patch-aligned slabs of one large waterfall,
and the flags are gathered back to every rank.
"""

import contextlib
import logging
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import (
    fused_extract_channels,
    fused_extract_channels_plain,
    mad_flag_patches,
    mad_flag_patches_plain,
)
from ..parallel.mesh import batch_placement
from ..preprocess import pipeline as P
from ..train.coherent_trainer import robust_scale, to_8ch
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.progress import progress
from .ms_loader import MSLoader

logger = logging.getLogger(__name__)

__all__ = ["flag_measurement_set", "flag_waterfalls", "flag_waterfalls_coherent"]


def _as_waterfalls(waterfalls, device):
    """(M, C, T) array or tensor -> complex64 or float32 tensor on device
    (the reference's dtypes with 64-bit types disabled)."""
    x = torch.as_tensor(waterfalls)
    dtype = torch.complex64 if x.is_complex() else torch.float32
    x = x.to(device=device, dtype=dtype)
    if x.ndim != 3:
        raise ValueError(f"Expected (M, C, T) waterfalls, got {tuple(x.shape)}")
    return x.contiguous()


def _split_channels(flat, n_ax, patch_size):
    """(M, C, T) -> (M * split, C_p / split, T) patch-aligned channel slabs
    (C zero-padded to C_p, a whole number of patch rows a slab) so that M *
    split covers ``n_ax`` where it can; returns the slabs and ``split``."""
    m0, c0, t0 = flat.shape
    rows = -(-c0 // patch_size)
    split = min(rows, -(-n_ax // m0))
    rows_p = -(-rows // split) * split
    pad_c = rows_p * patch_size - c0
    if pad_c:
        flat = torch.cat([flat, flat.new_zeros((m0, pad_c, t0))], 1)
    return flat.reshape(m0 * split, rows_p // split * patch_size, t0), split


def flag_waterfalls(waterfalls, method="mad", sigma=5.0, patch_size=128,
                    predictor=None, threshold=0.5, use_pallas="auto", mesh=None,
                    device=None):
    """Flag a batch of waterfalls.

    Args:
        waterfalls: (M, C, T) complex or real numpy array or tensor.
        method: ``"mad"`` (per-patch MAD threshold at ``sigma``) or
            ``"model"``.
        patch_size: side of the square patches; a waterfall no larger
            than one patch is flagged as a single patch of its own shape.
        predictor: for ``method="model"``, a callable (N, p, p, 3) float32
            tensor -> (N, p, p) bool or probabilities (cut at
            ``threshold``), e.g. :class:`~rfi_toolbox_tpu_torch.serving.CompiledPredictor`.
        use_pallas: ``"auto"`` or True calls the kernel wrappers (K5, K4),
            which launch the kernel on a CUDA tensor and run its plain
            version on a CPU tensor; False asks for the plain versions on
            any device (the JAX argument's name and meaning).
        mesh: a :class:`~rfi_toolbox_tpu_torch.parallel.mesh.Mesh` with a
            'data' axis; every rank passes the same waterfalls and gets all
            the flags. Each rank flags its waterfalls (all of them where M
            does not divide the axis: 15 baselines on 8 ranks still run).
            When M is smaller than the axis and C larger than a patch, the
            channel axis is first cut into patch-aligned slabs that become
            extra waterfalls; flags are per patch, so the result is the
            meshless one exactly.
        device: ``None`` for the CUDA card (this rank's), or e.g. ``"cpu"``.

    Returns:
        (M, C, T) bool tensor on the device.
    """
    with span("flag.call"):
        if use_pallas not in ("auto", True, False):
            raise ValueError(f"use_pallas must be 'auto', True or False, got {use_pallas!r}")
        kernels = use_pallas is not False
        dev = resolve_device(device)
        flat = _as_waterfalls(waterfalls, dev)
        m0, c0, t0 = flat.shape
        split, rows = 1, None
        if mesh is not None:
            n_ax = mesh.shape["data"]
            if m0 < n_ax and c0 > patch_size:
                flat, split = _split_channels(flat, n_ax, patch_size)
            rows = batch_placement(flat.shape[0], mesh)
            if rows.axis is None:  # replicated: the whole batch on every rank
                rows = None
            else:
                flat = rows.local(flat)
        m, c, t = flat.shape
        patched = not (c <= patch_size and t <= patch_size and split == 1)
        with span("flag.patchify"):
            patches = P.patchify_batch(flat, patch_size).contiguous() if patched else flat

        if method == "mad":
            with span("flag.mad"):
                flags = (mad_flag_patches if kernels else mad_flag_patches_plain)(patches, sigma)
        elif method == "model":
            if predictor is None:
                raise ValueError("method='model' requires a predictor")
            extract = fused_extract_channels if kernels else fused_extract_channels_plain
            with span("flag.extract"):
                images = extract(patches)
            with span("flag.predict"):
                preds = torch.as_tensor(predictor(images), device=dev)
            flags = preds if preds.dtype == torch.bool else preds > threshold
        else:
            raise ValueError(f"Unknown method '{method}' (use 'mad' or 'model')")

        with span("flag.unpatchify"):
            if patched:
                flags = P.unpatchify_batch(flags, m, c, t)
        if rows is not None:
            parts = [torch.empty_like(flags, dtype=torch.uint8) for _ in range(mesh.shape["data"])]
            dist.all_gather(parts, flags.to(torch.uint8).contiguous(),
                            group=mesh.get_group("data"))
            flags = torch.cat(parts).bool()
        if split > 1:
            flags = flags.reshape(m0, -1, t0)[:, :c0]
        return flags


def flag_waterfalls_coherent(vis4, predictor, patch_size=128, threshold=0.5,
                             device=None):
    """Flag (B, 4, C, T) 4-pol complex waterfalls with an 8-channel
    coherent model (``pretrained/unet*_coherent8ch.npz``).

    Each baseline's four polarisations are patchified together into
    4 pols x (re, im) = 8-channel patches, each robust-scaled on its own
    (median and interquartile range over its 8 channels; the zero padding
    of edge patches is left out of the statistics), flagged by the
    predictor and put back together: one (C, T) mask a baseline, shared
    by its four polarisations.

    Args:
        vis4: (B, 4, C, T) complex numpy array or tensor.
        predictor: callable (N, p, p, 8) float32 tensor -> (N, p, p) bool
            or probabilities (cut at ``threshold``), e.g.
            ``CompiledPredictor.from_snapshot("pretrained/unet24gn_coherent8ch.npz")``.
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.

    Returns:
        (B, C, T) bool tensor on the device.
    """
    with span("coherent.call"):
        dev = resolve_device(device)
        vis4 = torch.as_tensor(vis4).to(device=dev, dtype=torch.complex64)
        if vis4.ndim != 4 or vis4.shape[1] != 4:
            raise ValueError(f"Expected (B, 4, C, T) 4-pol waterfalls, got {tuple(vis4.shape)}")
        b, _, c, t = vis4.shape
        images = coherent_images(vis4, patch_size)
        with span("coherent.predict"):
            preds = torch.as_tensor(predictor(images), device=dev)
        preds = preds if preds.dtype == torch.bool else preds > threshold
        with span("coherent.unpatchify"):
            return P.unpatchify_batch(preds, b, c, t)


def coherent_images(vis4, patch_size):
    """(B, 4, C, T) complex64 -> (B * N, p, p, 8) float32 robust-scaled
    patches, N patches a plane in ``patchify_batch``'s order
    (flagging.py:184-222), in the ``coherent.images`` span; the robust
    scale in ``coherent.scale`` inside it."""
    with span("coherent.images"):
        b, _, c, t = vis4.shape
        p = patch_size
        patches = P.patchify_batch(vis4.reshape(b * 4, c, t), p)  # (b * 4 * N, p, p)
        n = patches.shape[0] // (b * 4)
        x = to_8ch(patches.reshape(b, 4, n, p, p).transpose(1, 2)).reshape(b * n, p, p, 8)
        valid = None
        if c % p or t % p:
            # edge patches hold patchify's zero padding; it stays out of the
            # median and the quartiles (q25 would pin to 0 past 25% padding)
            ones = torch.ones((1, c, t), device=vis4.device)
            valid = (P.patchify_batch(ones, p) > 0).repeat(b, 1, 1)[..., None]
        with span("coherent.scale"):
            return robust_scale(x, valid)


@contextlib.contextmanager
def _stage(name, timings, dev):
    """A stage of ``flag_measurement_set`` in its ``ms.<name>`` span.
    With ``timings`` (a dict) its host seconds are added there under
    ``name``, the card waited for at its end; None: nothing is timed and
    the card is not waited for."""
    with span(f"ms.{name}"):
        if timings is None:
            yield
            return
        t = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize()
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t


def _flag_block(vis, method, sigma, patch_size, predictor, threshold, use_pallas,
                mesh, dev, timings):
    """(B, P, C, T) complex128 host visibilities -> (B, P, C, T) bool host
    flags: one cast to complex64 on the host, one copy to the card, one
    flagging call, one copy back."""
    b, p, c, t = vis.shape
    with _stage("to_card", timings, dev):
        x = torch.from_numpy(vis.astype(np.complex64)).to(dev)
    if method == "model8":
        if predictor is None:
            raise ValueError("method='model8' requires a predictor")
        if p != 4:
            raise ValueError(f"method='model8' needs 4 polarizations, MS has {p}")
        with _stage("card", timings, dev):
            flags = flag_waterfalls_coherent(x, predictor, patch_size=patch_size,
                                             threshold=threshold, device=dev)
        with _stage("to_host", timings, dev):
            # one (C, T) mask a baseline, shared by the 4 pols
            flags = np.broadcast_to(flags.cpu().numpy()[:, None], (b, p, c, t)).copy()
    else:
        with _stage("card", timings, dev):
            flags = flag_waterfalls(x.reshape(b * p, c, t), method=method, sigma=sigma,
                                    patch_size=patch_size, predictor=predictor,
                                    threshold=threshold, use_pallas=use_pallas, mesh=mesh,
                                    device=dev)
        with _stage("to_host", timings, dev):
            flags = flags.cpu().numpy().reshape(b, p, c, t)
    return flags


def flag_measurement_set(ms, method="mad", sigma=5.0, patch_size=128, predictor=None,
                         threshold=0.5, num_antennas=None, mode="DATA", field_id=None,
                         merge_existing=False, use_pallas="auto", streaming=False,
                         mesh=None, device=None, timings=None):
    """Flag an entire measurement set and write the FLAG column back.

    Two modes:

    - bulk (default): one ``MSLoader.load`` (one query and one getcol a
      SPW), all baselines x pols flagged in one call on the card, one
      ``save_flags``. An MS the bulk layout cannot hold (a baseline with
      missing integrations: ``load`` raises ``ValueError``) is flagged in
      the streaming mode instead;
    - ``streaming=True``: baseline by baseline, a prefetch thread loading
      baseline i+1 on the host while the card flags baseline i; a
      baseline whose load fails is reported in ``failed`` and skipped.

    Args:
        ms: MS path (casatools) or :class:`~rfi_toolbox_tpu_torch.io.fake_ms.FakeMS`.
        method: ``"mad"`` or ``"model"`` (see :func:`flag_waterfalls`), or
            ``"model8"``: the coherent 8-channel convention
            (:func:`flag_waterfalls_coherent`), one mask a time-frequency
            cell written to all 4 pols, with an 8-channel predictor such as
            ``CompiledPredictor.from_snapshot("pretrained/unet16gn_coherent8ch.npz")``.
        num_antennas: limit the ANTENNA1 loop (the reference's semantics).
        merge_existing: OR the new flags into the existing FLAG column.
        use_pallas: see :func:`flag_waterfalls`.
        mesh: see :func:`flag_waterfalls` (``mad`` and ``model``; ignored,
            with a warning, by ``model8``). Every rank loads the MS and
            flags its share; rank 0 writes the FLAG column, the other
            ranks wait for it and return the same result.
        device: ``None`` for the CUDA card (this rank's), or e.g. ``"cpu"``.
        timings: optional dict; the host seconds of each stage are added
            to it under ``load``, ``to_card``, ``card``, ``to_host`` and
            ``save`` (the card is waited for at each stage's end).

    Returns:
        dict: {'baselines': int, 'flagged_fraction': float, 'failed': [...]}
    """
    dev = resolve_device(device)
    if method == "model8" and mesh is not None:
        logger.warning(
            "mesh is ignored with method='model8': the 8-channel "
            "predictor owns its device placement (AOT-compiled "
            "single-device executable)"
        )
    args = dict(method=method, sigma=sigma, patch_size=patch_size, predictor=predictor,
                threshold=threshold, use_pallas=use_pallas,
                mesh=None if method == "model8" else mesh, dev=dev, timings=timings)
    writer = mesh is None or dist.get_rank() == 0
    ragged = None
    with _stage("load", timings, dev):
        loader = MSLoader(ms, field_id=field_id)
        if not streaming:
            try:
                data = loader.load(num_antennas=num_antennas, mode=mode)
            except ValueError as e:
                ragged = e
    if ragged is not None:
        # a ragged observation (an antenna offline for part of the run):
        # the bulk layout cannot hold it; the per-baseline path can, and
        # reports bad baselines in 'failed'
        logger.warning("bulk load failed (%s); falling back to per-baseline "
                       "streaming", ragged)
        loader.close()
        return flag_measurement_set(
            ms, method=method, sigma=sigma, patch_size=patch_size,
            predictor=predictor, threshold=threshold, num_antennas=num_antennas,
            mode=mode, field_id=field_id, merge_existing=merge_existing,
            use_pallas=use_pallas, streaming=True, mesh=mesh, device=device,
            timings=timings)
    if not streaming:
        if len(data) == 0:
            loader.close()
            return {"baselines": 0, "flagged_fraction": 0.0, "failed": []}
        flags = _flag_block(data, **args)
        with _stage("save", timings, dev):
            if merge_existing:
                flags |= loader.load_flags()
            if writer:
                loader.save_flags(flags)
            _wait_for_writer(mesh)
            loader.close()
        return {"baselines": data.shape[0], "flagged_fraction": float(flags.mean()),
                "failed": []}

    pairs = [(i, j) for i in range(num_antennas or loader.num_antennas)
             for j in range(i + 1, loader.num_antennas)]
    if not pairs:
        loader.close()
        return {"baselines": 0, "flagged_fraction": 0.0, "failed": []}

    # the prefetch thread only reads the MS on the host; all work on the
    # card, and every span, stays on this thread
    loaded = {}

    def load_one(pair):
        try:
            loaded[pair] = loader.load_baseline(pair[0], pair[1], mode=mode,
                                                field_id=field_id)
        except Exception as e:  # surfaced per baseline in the result
            loaded[pair] = e

    total_flagged = 0.0
    total_pixels = 0
    n_done = 0
    failed = []
    prefetch = threading.Thread(target=load_one, args=(pairs[0],))
    prefetch.start()
    for idx, pair in progress(list(enumerate(pairs)), desc="Baselines", total=len(pairs)):
        with _stage("load", timings, dev):
            prefetch.join()
            data = loaded.pop(pair)
            if idx + 1 < len(pairs):
                prefetch = threading.Thread(target=load_one, args=(pairs[idx + 1],))
                prefetch.start()
        if isinstance(data, Exception):
            logger.warning("baseline %s load failed: %s", pair, data)
            failed.append({"baseline": pair, "error": str(data)})
            continue
        if data.shape[-1] == 0:
            continue
        flags = _flag_block(data[None], **args)[0]
        with _stage("save", timings, dev):
            if merge_existing:
                flags |= loader.load_baseline_flags(pair[0], pair[1], field_id=field_id)
            if writer:
                loader.save_baseline_flags(pair[0], pair[1], flags, field_id=field_id)
        total_flagged += float(flags.sum())
        total_pixels += flags.size
        n_done += 1

    _wait_for_writer(mesh)
    loader.close()
    return {"baselines": n_done, "flagged_fraction": total_flagged / max(total_pixels, 1),
            "failed": failed}


def _wait_for_writer(mesh):
    """On a mesh, the ranks wait here until rank 0 has written."""
    if mesh is not None:
        dist.barrier()
