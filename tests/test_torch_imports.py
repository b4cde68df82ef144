"""The port stands alone: it imports neither JAX nor the JAX package, its
kernels are plain-C CUDA sources built by nvcc (no PyTorch headers, no
torch.utils.cpp_extension), and its entry points want the card unless
the caller asks for the CPU."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rfi_toolbox_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rfi_toolbox_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out():
    code = (
        "import sys, rfi_toolbox_tpu_torch, rfi_toolbox_tpu_torch.io, "
        "rfi_toolbox_tpu_torch.serving, rfi_toolbox_tpu_torch.evaluation, "
        "rfi_toolbox_tpu_torch.ops, rfi_toolbox_tpu_torch.utils\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
            assert "cpp_extension" not in name, f"{path}: imports {name}"


def test_kernel_sources_are_plain_c_interface():
    from rfi_toolbox_tpu_torch.ops import _lib

    sources = sorted((PORT / "ops" / "csrc").glob("*.cu*"))
    assert {p.name for p in sources} >= {"fused_channels.cu", "mad_flags.cu"}
    text = "\n".join(p.read_text() for p in sources)
    assert not re.search(r"#include\s*[<\"](torch|ATen|c10|pybind11)", text)
    for name in _lib._SIGNATURES:
        assert re.search(rf'extern "C" int {name}\(', text), name
    assert "sm_90a" in " ".join(_lib.NVCC_FLAGS)
    assert _lib.BUILD_DIR == ROOT / "build" / "torch_kernels"


def test_library_name_follows_sources(tmp_path, monkeypatch):
    from rfi_toolbox_tpu_torch.ops import _lib

    monkeypatch.setattr(_lib, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text("// one\n")
    first = _lib._library_path()
    assert first == _lib._library_path()
    (tmp_path / "a.cu").write_text("// two\n")
    assert _lib._library_path() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from rfi_toolbox_tpu_torch.ops import _lib

    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    _lib.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _lib.load()
    finally:
        _lib.load.cache_clear()


def test_entry_points_want_the_card():
    """Without a card, the default device raises; device='cpu' works."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from rfi_toolbox_tpu_torch.io import flag_waterfalls
    from rfi_toolbox_tpu_torch.models import UNet
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor
    from rfi_toolbox_tpu_torch.utils import resolve_device

    vis = np.ones((1, 16, 16), np.complex64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flag_waterfalls(vis)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledPredictor(UNet(init_features=2, depth=2))
    assert resolve_device("cpu") == torch.device("cpu")
    assert flag_waterfalls(vis, device="cpu").shape == (1, 16, 16)


def test_set_tf32_sets_both_switches():
    from rfi_toolbox_tpu_torch.utils import set_tf32

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        set_tf32(True)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        set_tf32(False)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
