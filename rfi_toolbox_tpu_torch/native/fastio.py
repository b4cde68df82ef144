"""ctypes bindings for the fastio native reader (``fastio.cpp``).

The port's copy of ``rfi_toolbox_tpu/native/fastio.py``. On first use
``g++ -O3`` compiles the source into ``build/fastio/`` at the root of the
checkout, under a name that follows a hash of the source (a new source
builds anew; a build is written to a temporary name and renamed, so that
processes building at once do not clash). Nothing is built at import.
Without a compiler the import still succeeds and ``fastio_available()``
returns False: callers read with numpy instead. This is host I/O, not a
device kernel.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["FastNpyReader", "iter_npy_prefetched", "fastio_available"]

_SRC = Path(__file__).with_name("fastio.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fastio"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lib = None
_build_error = None

_DTYPE_MAP = {
    "<f4": np.float32,
    "<f8": np.float64,
    "<c8": np.complex64,
    "<c16": np.complex128,
    "|u1": np.uint8,
    "|i1": np.int8,
    "<i4": np.int32,
    "<i8": np.int64,
    "|b1": np.bool_,
    "<u4": np.uint32,
}


def _library_path():
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"_fastio_{h.hexdigest()[:16]}.so"


def _build(path):
    global _build_error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        _build_error = getattr(e, "stderr", b"") or str(e)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _library_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path))
    lib.fastio_open.restype = ctypes.c_void_p
    lib.fastio_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.fastio_next.restype = ctypes.c_int
    lib.fastio_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fastio_free.argtypes = [ctypes.c_void_p]
    lib.fastio_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def fastio_available():
    """True when the native library can be built and loaded."""
    return _load() is not None


class FastNpyReader:
    """In-order prefetching reader over a list of .npy files.

    >>> with FastNpyReader(paths, n_threads=2) as r:
    ...     for arr in r:
    ...         ...  # numpy array
    """

    def __init__(self, paths, n_threads=2, queue_depth=4):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"fastio native library unavailable: {_build_error!r}"
            )
        self._lib = lib
        self._paths = [str(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        self._handle = lib.fastio_open(
            arr, len(self._paths), n_threads, queue_depth
        )
        self._closed = False

    def __iter__(self):
        data = ctypes.c_void_p()
        nbytes = ctypes.c_longlong()
        dtype_buf = ctypes.create_string_buffer(16)
        shape = (ctypes.c_longlong * 8)()
        ndim = ctypes.c_int()
        while True:
            seq = self._lib.fastio_next(
                self._handle, ctypes.byref(data), ctypes.byref(nbytes),
                dtype_buf, shape, ctypes.byref(ndim),
            )
            if seq == -1:
                return
            if seq == -2:
                raise IOError(
                    f"fastio: failed to read {self._paths[0]} (bad .npy?)"
                )
            descr = dtype_buf.value.decode()
            np_dtype = _DTYPE_MAP.get(descr)
            if np_dtype is None:
                self._lib.fastio_free(data)
                raise ValueError(f"fastio: unsupported dtype {descr!r}")
            shp = tuple(shape[i] for i in range(ndim.value))
            buf = ctypes.cast(
                data, ctypes.POINTER(ctypes.c_char * nbytes.value)
            ).contents
            out = np.frombuffer(buf, dtype=np_dtype).reshape(shp).copy()
            self._lib.fastio_free(data)
            yield out

    def close(self):
        if not self._closed:
            self._lib.fastio_close(self._handle)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def iter_npy_prefetched(paths, n_threads=2, queue_depth=4):
    """Generator over the arrays of ``paths``, in order: the native reader,
    or ``np.load`` when the native library is unavailable."""
    if fastio_available():
        with FastNpyReader(paths, n_threads, queue_depth) as r:
            yield from r
    else:
        for p in paths:
            yield np.load(p)
