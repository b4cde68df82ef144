"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface and include no
PyTorch header. On first use, one ``nvcc`` call compiles all of them
for ``sm_90a`` into one shared library under ``build/torch_kernels/``
at the root of the checkout, named by a hash of the sources and flags,
and ``ctypes`` loads it. Nothing is built at import time, and a CPU
tensor never needs the library.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then on ``PATH``, then in
``/usr/local/cuda/bin``. The compiler's report (``-Xptxas -v``: each
kernel's registers, shared memory and spills) is kept beside the
library as ``nvcc.log``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["load", "check", "stream_of", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes; every one returns a cudaError_t as int
_SIGNATURES = {
    # in, out, n, h, w, is_complex, stream
    "rfi_fused_extract_channels": (_P, _P, _I, _I, _I, _I, _P),
    # in, flags, scratch, n, hw, is_complex, sigma, stream
    "rfi_mad_flag_patches": (_P, _P, _P, _I, _I, _I, _F, _P),
}


class KernelLibrary:
    """The loaded shared library, its path and how long it took to build
    (0.0 when an earlier build of the same sources was found)."""

    def __init__(self, path, build_seconds):
        self.path = path
        self.build_seconds = build_seconds
        self.cdll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def _nvcc():
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"librfi_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load():
    """Build (once per source version) and load the kernel library."""
    path = _library_path()
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in _sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        (BUILD_DIR / "nvcc.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, path)
    return KernelLibrary(path, seconds)


def check(rc, name):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(tensor):
    """The current CUDA stream of the tensor's device, as a pointer."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
