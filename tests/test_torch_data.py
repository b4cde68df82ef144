"""Port parity: the on-disk dataset path (``BatchWriter``,
``StreamingDataset``, ``load_batches``, ``.pt`` files and the native
``.npy`` reader) against the JAX package, on the CPU.

Everything here is exact: the same files, the same arrays bit for bit and
the same minibatches in the same order for the same numpy rng.
"""

import json
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.data import ArrayDataset as JaxArrayDataset
from rfi_toolbox_tpu.data import BatchWriter as JaxBatchWriter
from rfi_toolbox_tpu.data import StreamingDataset as JaxStreamingDataset
from rfi_toolbox_tpu.data import load_batches as jax_load_batches
from rfi_toolbox_tpu_torch.data import (
    ArrayDataset,
    BatchWriter,
    StreamingDataset,
    load_batches,
)
from rfi_toolbox_tpu_torch.native import FastNpyReader, fastio
from rfi_toolbox_tpu_torch.native import fastio_available

HW = 6


def _samples(rng, n):
    images = rng.normal(size=(n, HW, HW, 3)).astype(np.float32)
    labels = (rng.random((n, HW, HW)) < 0.4).astype(np.uint8)
    images[:, 0, 0, 0] = np.arange(n)  # a sample's identity
    return images, labels


def _write(writer_cls, directory, chunks, per_file, fmt, tensors=False):
    """BatchWriter output of ``chunks`` (lists of (images, labels))."""
    writer = writer_cls(directory, samples_per_batch=per_file, format=fmt)
    for images, labels in chunks:
        if tensors:
            images, labels = torch.from_numpy(images), torch.from_numpy(labels)
        writer.add_batch(ArrayDataset(images, labels))
    return writer.finalize()


def _chunks(rng, sizes):
    images, labels = _samples(rng, sum(sizes))
    bounds = np.cumsum([0, *sizes])
    return [(images[a:b], labels[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def _pt_dir(directory, chunks):
    """A reference-format .pt batch directory: one torch.save'd dict a
    chunk, partial chunks, no metadata.json."""
    directory.mkdir(parents=True, exist_ok=True)
    for i, (images, labels) in enumerate(chunks):
        torch.save({"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)},
                   directory / f"batch_{i:03d}.pt")


@pytest.fixture(params=["npz", "npy", "pt"])
def batch_dir(request, tmp_path):
    """One directory of batch files (22 samples) in each format."""
    chunks = _chunks(np.random.default_rng(1), [5, 9, 3, 5])
    d = tmp_path / request.param
    if request.param == "pt":
        _pt_dir(d, chunks)
    else:
        _write(BatchWriter, d, chunks, 6, request.param)
    return d


@pytest.mark.parametrize("fmt", ["npz", "npy"])
def test_batch_writer_matches_jax(tmp_path, fmt):
    chunks = _chunks(np.random.default_rng(0), [4, 7, 2, 9, 1])
    got = _write(BatchWriter, tmp_path / "port", chunks, 5, fmt, tensors=True)
    want = _write(JaxBatchWriter, tmp_path / "jax", chunks, 5, fmt)
    assert got == want
    assert json.loads((tmp_path / "port" / "metadata.json").read_text()) == \
        json.loads((tmp_path / "jax" / "metadata.json").read_text())
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert got["num_batches"] == 5 and got["num_samples"] == 23
    for name in names:
        if name.endswith(".json"):
            continue
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if fmt == "npy":
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files
                for k in x.files:
                    assert x[k].dtype == y[k].dtype
                    np.testing.assert_array_equal(x[k], y[k])


def _epoch(stream, batch_size, seed, pool):
    rng = None if seed is None else np.random.default_rng(seed)
    return list(stream.iter_epoch(batch_size, rng, shuffle_buffer_files=pool))


@pytest.mark.parametrize("seed, pool, batch_size", [
    (None, 4, 4),   # file order, no shuffle
    (3, 1, 4),      # shuffled files, within-file permutation
    (3, 4, 4),      # the k-file shuffle pool
    (11, 2, 5),     # a pool of 2, batches across files
    (5, 4, 30),     # a dataset smaller than one batch
])
def test_streaming_minibatches_match_jax(batch_dir, seed, pool, batch_size):
    port, jax_ = StreamingDataset(batch_dir), JaxStreamingDataset(batch_dir)
    assert len(port) == len(jax_) == 22
    assert port.image_shape == tuple(jax_.image_shape)
    got = _epoch(port, batch_size, seed, pool)
    want = _epoch(jax_, batch_size, seed, pool)
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    if seed is not None:  # the shuffle mixes files
        assert not np.array_equal(got[0][0][:, 0, 0, 0], np.arange(len(got[0][0])))
    assert port.max_resident_files <= 3
    assert port.last_reader == jax_.last_reader
    if pool > 1 and seed is not None:
        assert port.pool_peak_files == jax_.pool_peak_files


def test_streaming_reads_every_sample_once(batch_dir):
    stream = StreamingDataset(batch_dir)
    seen = np.concatenate([b[0][:, 0, 0, 0] for b in stream.iter_epoch(
        3, np.random.default_rng(2), drop_remainder=False)])
    np.testing.assert_array_equal(np.sort(seen), np.arange(22))


def test_load_batches_matches_jax(batch_dir):
    for prefetch in (True, False):
        got = list(load_batches(batch_dir, prefetch=prefetch))
        want = list(jax_load_batches(batch_dir, prefetch=prefetch))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert isinstance(g, ArrayDataset)
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.labels, w.labels)


def test_residency_is_bounded_and_early_abort_does_not_hang(tmp_path):
    chunks = _chunks(np.random.default_rng(4), [4] * 12)
    _write(BatchWriter, tmp_path / "d", chunks, 4, "npz")
    stream = StreamingDataset(tmp_path / "d")
    for _ in stream.iter_epoch(4, np.random.default_rng(0)):
        pass
    assert stream.max_resident_files <= 3
    assert stream.pool_peak_files <= 5  # the 4-file pool and a refill

    def abort():
        it = stream.iter_epoch(4, None)
        next(it)
        it.close()

    before = threading.active_count()
    t = threading.Thread(target=abort)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "closing an epoch early hung"
    assert stream._resident == 0
    for _ in range(100):  # the producer thread ends
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_pt_file_loads_through_both_packages(tmp_path):
    images, labels = _samples(np.random.default_rng(5), 4)
    path = tmp_path / "data.pt"
    torch.save({"images": torch.from_numpy(images), "labels": torch.from_numpy(labels),
                "metadata": {"source": "reference", "n": 4}}, path)
    for cls in (ArrayDataset, JaxArrayDataset):
        ds = cls.load_from_disk(path)
        np.testing.assert_array_equal(ds.images, images)
        np.testing.assert_array_equal(ds.labels, labels)
        assert ds.metadata == {"source": "reference", "n": 4}


def test_streaming_counts_a_pt_directory_without_metadata(tmp_path):
    _pt_dir(tmp_path / "pt", _chunks(np.random.default_rng(6), [3, 1, 4]))
    stream = StreamingDataset(tmp_path / "pt")
    assert stream.metadata == {} and len(stream) == 8
    assert stream.image_shape == (HW, HW, 3)


def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no batch_"):
        StreamingDataset(tmp_path)


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128",
                                   "uint8", "int8", "int32", "int64", "bool", "uint32"])
def test_fastio_reader_matches_np_load(tmp_path, dtype):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native reader cannot be built")
    assert fastio_available()
    assert fastio._library_path().parent == fastio.BUILD_DIR
    rng = np.random.default_rng(7)
    arrays = [(rng.normal(size=shape) * 50).astype(dtype) for shape in
              [(3, 4, 5), (7,), (2, 1, 3, 2)]]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(tmp_path / f"a{i}.npy")
        np.save(paths[-1], a)
    with FastNpyReader(paths) as reader:
        got = list(reader)
    assert len(got) == len(arrays)
    for g, p in zip(got, paths):
        want = np.load(p)
        assert g.dtype == want.dtype and g.shape == want.shape
        np.testing.assert_array_equal(g, want)
