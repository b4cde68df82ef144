"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface and include no
PyTorch header. On first use, one ``nvcc`` process per source compiles
them for ``sm_90a``, all started together, and one more links the
objects into a shared library under ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the sources and flags;
``ctypes`` loads it. Nothing is built at import time, and a CPU tensor
never needs the library.

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PI, _PL = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
# C entry point -> argtypes; every one returns a cudaError_t as int
_SIGNATURES = {
    # in, out, n, h, w, is_complex, stream
    "rfi_fused_extract_channels": (_P, _P, _I, _I, _I, _I, _P),
    # in, flags, scratch, n, hw, is_complex, sigma, stream
    "rfi_mad_flag_patches": (_P, _P, _P, _I, _I, _I, _F, _P),
    # in, grad3, amp, phase, n, h, w, is_complex, stream
    "rfi_fused_extract_channel_planes": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # in, base_idx, pidx, grad, amp, phase, m, k, h, w, is_complex, stream
    "rfi_fused_gather_extract": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # kind (0 K2, 1 K1, 2 K4), is_complex, h, w, out: CTAs an SM, clusters
    # on the card, dynamic shared memory bytes a CTA
    "rfi_channel_planes_occupancy": (_I, _I, _I, _I, _PI),
    # grad3, log_amp, phase, base_idx (or None), pidx (or None), variant, out,
    # m, k, h, w, pixel stride (1 planes, 3 images), int64 indices, stream
    "rfi_fused_plane_gather_transform": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # TMA, pixel stride, out: CTAs an SM, CTAs on the card, shared bytes a CTA
    "rfi_plane_gather_occupancy": (_I, _I, _PI),
    # kind (0 K2, 2 K4), in, out, amp, phase, keys, n, h, w, is_complex, stream
    "rfi_extract_strips": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # kind (0 K2, 1 K1, 2 K4), in, base_idx, pidx, out, amp, phase, scratch,
    # n, k, h, w, rows, is_complex, stream
    "rfi_extract_groups": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # kind, is_complex, out: CTAs an SM, CTAs on the card, shared bytes a CTA
    "rfi_extract_groups_occupancy": (_I, _I, _PI),
    # x, w, b (or None), y, n, h, w, ci, co, relu, stream
    "rfi_conv3x3": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # n, h, w, ci, co, out: splits
    "rfi_conv3x3_dw_splits": (_I, _I, _I, _I, _I, _PI),
    # x, g, partial, dw, n, h, w, ci, co, splits, stream
    "rfi_conv3x3_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # n, h, w, co, groups, out: double2 slots of each stats scratch
    "rfi_double_conv_gn_workspace": (_I, _I, _I, _I, _I, _PL),
    # x, w1, g1, b1, w2, g2, b2, mid, out, stats1, stats2, n, h, w, ci, co,
    # groups, eps, stream
    "rfi_double_conv_gn": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _F, _P),
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
        nvcc = _nvcc()
        objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
        t0 = time.perf_counter()
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(_sources(), objects))
        ]
        log, failed = [], []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        if not failed:
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *(str(o) for o in objects)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stdout + proc.stderr)
        seconds = time.perf_counter() - t0
        (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
        for obj in objects:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
        os.replace(tmp, path)
    return KernelLibrary(path, seconds)


def check(rc, name):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(tensor):
    """The current CUDA stream of the tensor's device, as a pointer."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
