"""Datasets of (image, label) pairs, in memory and in batch files on disk.

Counterpart of ``rfi_toolbox_tpu/data/batched_dataset.py``:

- ``ArrayDataset`` (and its alias ``TorchDataset``), the container that
  ``Preprocessor.create_dataset`` returns. Tensors stay on their device;
  anything else becomes a numpy array. ``save_to_disk`` writes the JAX
  package's single-file ``.npz`` (arrays ``images``, ``labels`` and the
  JSON string ``metadata``); ``load_from_disk`` reads that, and a
  reference-format ``.pt`` file (``torch.save`` of ``{"images",
  "labels", "metadata"}``).
- ``BatchWriter`` streams accumulated samples into ``batch_NNN.npz``
  files (or ``batch_NNN.images.npy`` / ``.labels.npy`` pairs) of
  ``samples_per_batch`` each and a ``metadata.json``; samples that
  arrive as CUDA tensors are copied to the host first.
- ``StreamingDataset`` reads such a directory (or a reference-format
  ``.pt`` one) with bounded host memory: a prefetch thread (or the
  native reader of :mod:`..native.fastio` for ``.npy`` pairs) and a
  shuffle pool of a few files.
- ``load_batches`` yields one ``ArrayDataset`` per batch file.

Either package reads the files the other writes.
"""

import json
import queue
import re
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "ArrayDataset",
    "TorchDataset",
    "BatchWriter",
    "StreamingDataset",
    "load_batches",
]


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _load_pt(path):
    """A reference-format ``.pt`` file: ``torch.save`` of a dict with
    ``images`` and ``labels`` tensors (and optional ``metadata``), read
    on the CPU with ``weights_only`` (plain tensors and containers, no
    pickled code)."""
    return torch.load(path, map_location="cpu", weights_only=True)


class ArrayDataset:
    """Images (N, H, W, 3) float32 and labels (N, H, W) uint8, with a
    metadata dict."""

    def __init__(self, images, labels, metadata=None):
        if not hasattr(images, "ndim"):
            images = np.asarray(images)
        if not hasattr(labels, "ndim"):
            labels = np.asarray(labels)
        if len(images) != len(labels):
            raise ValueError("Images and labels must have same length")
        self.images = images
        self.labels = labels
        self.metadata = metadata or {}

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return {"image": self.images[idx], "label": self.labels[idx]}

    def save_to_disk(self, path):
        """Write one ``.npz`` file (images, labels, JSON metadata); tensors
        are copied to the host. Returns the path."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, images=_numpy(self.images), labels=_numpy(self.labels),
                 metadata=json.dumps(self.metadata, default=str))
        return path

    @classmethod
    def load_from_disk(cls, path):
        """Read a ``.npz`` written by either package's ``save_to_disk``, or
        a reference-format ``.pt`` file; the arrays come back as numpy."""
        path = Path(path)
        if path.suffix == ".pt":
            data = _load_pt(path)
            return cls(_numpy(data["images"]), _numpy(data["labels"]),
                       data.get("metadata"))
        with np.load(path, allow_pickle=False) as data:
            metadata = json.loads(str(data["metadata"])) if "metadata" in data else {}
            return cls(data["images"], data["labels"], metadata)

    def __repr__(self):
        return (f"ArrayDataset(n={len(self)}, images={tuple(self.images.shape)}, "
                f"labels={tuple(self.labels.shape)})")


# the reference's name for the same container
TorchDataset = ArrayDataset


class BatchWriter:
    """Accumulates samples and writes fixed-size batch files to disk.

        writer = BatchWriter(output_dir, samples_per_batch=100)
        for ds in generate_batches():
            writer.add_batch(ds)
        writer.finalize()

    Args:
        output_dir: directory for the batch files.
        samples_per_batch: samples a batch file.
        format: ``'npz'`` (one container a batch) or ``'npy'`` (a
            ``batch_NNN.images.npy`` / ``.labels.npy`` pair, the layout the
            native reader takes without parsing a container).

    Every file but possibly the last holds exactly ``samples_per_batch``:
    a remainder waits for the next ``add_batch`` or for ``finalize``.
    """

    def __init__(self, output_dir, samples_per_batch=100, format="npz"):
        if format not in ("npz", "npy"):
            raise ValueError(f"format must be 'npz' or 'npy', got {format!r}")
        self.format = format
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.samples_per_batch = samples_per_batch
        self.accumulated_images = []
        self.accumulated_labels = []
        self.batch_file_idx = 0
        self.total_samples = 0
        self._last_shapes = (None, None)
        self._last_dtype = None

    def add_batch(self, dataset):
        """Add all samples of a dataset with ``.images`` and ``.labels``
        (numpy arrays or tensors on any device, copied to the host)."""
        self.accumulated_images.append(_numpy(dataset.images))
        self.accumulated_labels.append(_numpy(dataset.labels))
        current = sum(len(a) for a in self.accumulated_images)
        if current >= self.samples_per_batch:
            self._flush()

    def _flush(self, final=False):
        """Write the accumulated samples in ``samples_per_batch`` chunks;
        the remainder is held back unless ``final``."""
        if not self.accumulated_images:
            return
        images = np.concatenate(self.accumulated_images)
        labels = np.concatenate(self.accumulated_labels)
        self.accumulated_images = []
        self.accumulated_labels = []
        self._last_shapes = (list(images.shape[1:]), list(labels.shape[1:]))
        self._last_dtype = str(images.dtype)

        n = len(images)
        cut = n if final else (n // self.samples_per_batch) * self.samples_per_batch
        for start in range(0, cut, self.samples_per_batch):
            end = min(start + self.samples_per_batch, cut)
            stem = self.output_dir / f"batch_{self.batch_file_idx:03d}"
            if self.format == "npy":
                np.save(f"{stem}.images.npy", images[start:end])
                np.save(f"{stem}.labels.npy", labels[start:end])
            else:
                np.savez(f"{stem}.npz", images=images[start:end],
                         labels=labels[start:end])
            self.total_samples += end - start
            self.batch_file_idx += 1
        if cut < n:
            self.accumulated_images = [images[cut:]]
            self.accumulated_labels = [labels[cut:]]

    def finalize(self):
        """Flush the remaining samples and write ``metadata.json``; returns
        the metadata."""
        self._flush(final=True)
        metadata = {
            "num_samples": self.total_samples,
            "samples_per_batch": self.samples_per_batch,
            "num_batches": self.batch_file_idx,
            "image_shape": self._last_shapes[0],
            "mask_shape": self._last_shapes[1],
            "dtype": self._last_dtype,
            "format_version": 1,
            "file_format": self.format,
        }
        with open(self.output_dir / "metadata.json", "w") as f:
            json.dump(metadata, f, indent=2)
        return metadata


def _batch_index(path):
    """(index, name) of a batch_NNN* file, so that batch_1000 sorts after
    batch_999."""
    m = re.search(r"batch_(\d+)", Path(path).name)
    return (int(m.group(1)) if m else 0, Path(path).name)


def _scan_batch_files(directory):
    """The batch files of a directory as load units: ``.npz`` / ``.pt``
    paths, or (images.npy, labels.npy) pairs."""
    directory = Path(directory)
    npy_imgs = sorted(directory.glob("batch_*.images.npy"), key=_batch_index)
    if npy_imgs:
        return [
            (p, p.with_name(p.name.replace(".images.npy", ".labels.npy")))
            for p in npy_imgs
        ]
    return sorted(directory.glob("batch_*.npz"), key=_batch_index) + sorted(
        directory.glob("batch_*.pt"), key=_batch_index
    )


def _count_batch_file(unit):
    """Samples in one load unit: an ``.npy`` header only; an ``.npz`` or
    ``.pt`` file loaded and dropped (one file at a time)."""
    if isinstance(unit, tuple):
        return int(np.load(unit[0], mmap_mode="r").shape[0])
    return len(_load_batch_file(unit))


def _load_batch_file(unit):
    """One load unit as an ``ArrayDataset`` of numpy arrays."""
    if isinstance(unit, tuple):
        return ArrayDataset(np.load(unit[0]), np.load(unit[1]))
    if unit.suffix == ".pt":
        data = _load_pt(unit)
        return ArrayDataset(_numpy(data["images"]), _numpy(data["labels"]))
    with np.load(unit) as data:
        return ArrayDataset(data["images"], data["labels"])


class StreamingDataset:
    """Bounded-memory dataset over a ``BatchWriter`` directory.

    Batch files stream through a one-deep prefetch thread (or the native
    reader for ``.npy`` pairs), so that at most about 3 files are resident
    in the load pipeline (one consumed, one queued, one being read),
    whatever the dataset's size (``max_resident_files``). ``Trainer.fit``
    takes one (or a directory path) and moves each minibatch to the card
    as it arrives.

    Attributes:
        files: the load units, in batch order.
        metadata: ``metadata.json`` (empty without one).
        image_shape: one image's shape.
        max_resident_files: the most files loaded and not yet consumed at
            once in the load pipeline.
        pool_peak_files: the shuffle pool's largest size, in files.
        last_reader: ``'native'`` when the C++ reader carried the last
            epoch's reads, ``'python'`` for the thread.
    """

    def __init__(self, directory):
        self.directory = Path(directory)
        self.files = _scan_batch_files(self.directory)
        if not self.files:
            raise FileNotFoundError(f"no batch_* files under {self.directory}")
        meta_path = self.directory / "metadata.json"
        self.metadata = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        # the first file's sample count (the shuffle pool's refill target);
        # counting an .npz or .pt file loads it, so once
        self._first_file_count = None
        if "num_samples" in self.metadata:
            self._num_samples = int(self.metadata["num_samples"])
            self.image_shape = tuple(self.metadata["image_shape"])
        else:
            # no metadata.json (a reference .pt directory, whose writer
            # emits partial chunks mid-stream): count every file, one at a
            # time
            first = _load_batch_file(self.files[0])
            self.image_shape = tuple(first.images.shape[1:])
            self._first_file_count = len(first)
            self._num_samples = len(first) + sum(
                _count_batch_file(u) for u in self.files[1:]
            )
        self.max_resident_files = 0
        self.pool_peak_files = 0
        self.last_reader = None
        self._resident = 0
        self._lock = threading.Lock()

    def __len__(self):
        return self._num_samples

    def _track(self, delta):
        with self._lock:
            self._resident += delta
            self.max_resident_files = max(self.max_resident_files, self._resident)

    def _iter_files(self, order):
        """``ArrayDataset``s of the files in ``order`` through a prefetch
        pipeline: the native reader for ``.npy`` pairs when it builds, else
        a one-deep prefetch thread. The caller may close the generator
        early; both producers then stop."""
        if self.files and isinstance(self.files[0], tuple):
            from ..native.fastio import fastio_available

            if fastio_available():
                yield from self._iter_files_native(order)
                return
        self.last_reader = "python"
        yield from self._iter_files_python(order)

    def _iter_files_native(self, order):
        """One ``FastNpyReader`` over the epoch's interleaved (images,
        labels) paths; its queue of 4 arrays bounds the reader's side to 2
        file pairs beyond the one in hand."""
        from ..native.fastio import FastNpyReader

        self.last_reader = "native"
        paths = [p for i in order for p in self.files[i]]
        with FastNpyReader(paths, n_threads=2, queue_depth=4) as reader:
            it = iter(reader)
            for _ in order:
                images = next(it)
                labels = next(it)
                self._track(+1)
                try:
                    yield ArrayDataset(images, labels)
                finally:
                    self._track(-1)

    def _iter_files_python(self, order):
        q = queue.Queue(maxsize=1)
        stop = threading.Event()
        sentinel = object()

        def producer():
            try:
                for i in order:
                    if stop.is_set():
                        return
                    ds = _load_batch_file(self.files[i])
                    self._track(+1)
                    q.put(ds)
                q.put(sentinel)
            except BaseException as e:  # the consumer raises it
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, BaseException):
                    raise item
                try:
                    yield item
                finally:
                    del item
                    self._track(-1)
        finally:
            stop.set()
            # drain until the producer thread exits, not until the queue
            # looks empty: a producer blocked in q.put can complete its put
            # after an emptiness check and strand one tracked file
            while True:
                try:
                    leftover = q.get_nowait()
                except queue.Empty:
                    if not t.is_alive():
                        break
                    t.join(timeout=0.05)
                    continue
                if leftover is not sentinel and not isinstance(leftover, BaseException):
                    self._track(-1)

    def iter_epoch(self, batch_size, rng=None, drop_remainder=True,
                   shuffle_buffer_files=4):
        """Yield (images, labels) numpy minibatches of ``batch_size``, as
        the JAX package's ``iter_epoch`` yields them for the same ``rng``
        (a ``np.random.Generator``).

        With ``rng``: shuffled file order, and the samples pass through a
        pool of ``shuffle_buffer_files`` files that is permuted again at
        every refill (so a minibatch mixes up to k files; the pool is
        bounded by about k + 1 files, ``pool_peak_files``). Without ``rng``
        (or with one file, or a pool of 1): files in order, each permuted
        within by ``rng`` if given. Remainders carry across files; only the
        epoch's last partial batch is dropped (``drop_remainder``), and a
        dataset smaller than ``batch_size`` yields its one partial batch.
        """
        if rng is not None and shuffle_buffer_files > 1 and len(self.files) > 1:
            yield from self._iter_epoch_pooled(batch_size, rng, drop_remainder,
                                               shuffle_buffer_files)
            return
        order = (rng.permutation(len(self.files)) if rng is not None
                 else np.arange(len(self.files)))
        rem_i = rem_l = None
        yielded = False
        for ds in self._iter_files(order):
            imgs, lbls = ds.images, ds.labels
            if rng is not None:
                p = rng.permutation(len(imgs))
                imgs, lbls = imgs[p], lbls[p]
            if rem_i is not None:
                imgs = np.concatenate([rem_i, imgs])
                lbls = np.concatenate([rem_l, lbls])
            n = (len(imgs) // batch_size) * batch_size
            for s in range(0, n, batch_size):
                yield imgs[s:s + batch_size], lbls[s:s + batch_size]
                yielded = True
            rem_i, rem_l = ((imgs[n:].copy(), lbls[n:].copy()) if n < len(imgs)
                            else (None, None))
        if rem_i is not None and len(rem_i) and (not drop_remainder or not yielded):
            yield rem_i, rem_l

    def _iter_epoch_pooled(self, batch_size, rng, drop_remainder,
                           shuffle_buffer_files):
        """The k-file shuffle pool: fill from up to k files, permute the
        whole pool at every refill, serve minibatches from a cursor (the
        consumed rows are dropped once a refill)."""
        if self._first_file_count is None:
            self._first_file_count = _count_batch_file(self.files[0])
        per_file = max(self._first_file_count, 1)
        k = min(int(shuffle_buffer_files), len(self.files))
        target = k * per_file
        files_it = self._iter_files(rng.permutation(len(self.files)))
        exhausted = False
        pool_i = pool_l = None
        cursor = 0
        yielded = False
        try:
            while True:
                while not exhausted and (pool_i is None or len(pool_i) - cursor < target):
                    ds = next(files_it, None)
                    if ds is None:
                        exhausted = True
                        break
                    if pool_i is None:
                        pool_i, pool_l = ds.images, ds.labels
                    else:
                        pool_i = np.concatenate([pool_i[cursor:], ds.images])
                        pool_l = np.concatenate([pool_l[cursor:], ds.labels])
                    cursor = 0
                    p = rng.permutation(len(pool_i))
                    pool_i, pool_l = pool_i[p], pool_l[p]
                    with self._lock:
                        self.pool_peak_files = max(self.pool_peak_files,
                                                   -(-len(pool_i) // per_file))
                if pool_i is None:
                    return
                remaining = len(pool_i) - cursor
                if remaining >= batch_size:
                    yield (pool_i[cursor:cursor + batch_size],
                           pool_l[cursor:cursor + batch_size])
                    yielded = True
                    cursor += batch_size
                    continue
                if remaining and (not drop_remainder or not yielded):
                    yield pool_i[cursor:], pool_l[cursor:]
                return
        finally:
            files_it.close()


def load_batches(directory, prefetch=True):
    """Yield an ``ArrayDataset`` per batch file of a directory:
    ``batch_NNN.npz``, ``batch_NNN.{images,labels}.npy`` pairs (through
    the native prefetching reader with ``prefetch``, where it builds) and
    reference-format ``batch_NNN.pt``, in the JAX package's order."""
    directory = Path(directory)
    npy_imgs = sorted(directory.glob("batch_*.images.npy"))
    if npy_imgs:
        labels_files = [p.with_name(p.name.replace(".images.npy", ".labels.npy"))
                        for p in npy_imgs]
        if prefetch:
            from ..native.fastio import iter_npy_prefetched

            paths = [p for pair in zip(npy_imgs, labels_files) for p in pair]
            it = iter_npy_prefetched(paths)
            for _ in npy_imgs:
                yield ArrayDataset(next(it), next(it))
        else:
            for pi, pl in zip(npy_imgs, labels_files):
                yield ArrayDataset(np.load(pi), np.load(pl))
        return
    files = sorted(directory.glob("batch_*.npz")) + sorted(directory.glob("batch_*.pt"))
    for f in files:
        yield _load_batch_file(f)
