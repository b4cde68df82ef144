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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "torch_train_profile.py",
                                         ROOT / "tools" / "conv_library_kernels.py",
                                         ROOT / "tools" / "instance_grad_float64.py",
                                         ROOT / "tests" / "torch_parallel_ranks.py",
                                         ROOT / "tests" / "plain_coherent.py"]


def test_import_leaves_jax_out():
    code = (
        "import sys, rfi_toolbox_tpu_torch, rfi_toolbox_tpu_torch.io, "
        "rfi_toolbox_tpu_torch.serving, rfi_toolbox_tpu_torch.evaluation, "
        "rfi_toolbox_tpu_torch.ops, rfi_toolbox_tpu_torch.utils, "
        "rfi_toolbox_tpu_torch.train, rfi_toolbox_tpu_torch.synth, "
        "rfi_toolbox_tpu_torch.data, rfi_toolbox_tpu_torch.preprocess.static_prep, "
        "rfi_toolbox_tpu_torch.preprocess.preprocessor, rfi_toolbox_tpu_torch.models, "
        "rfi_toolbox_tpu_torch.ops.conv3x3, rfi_toolbox_tpu_torch.ops.fused_doubleconv, "
        "rfi_toolbox_tpu_torch.train.trainer, rfi_toolbox_tpu_torch.models.convert, "
        "rfi_toolbox_tpu_torch.data.batched_dataset, rfi_toolbox_tpu_torch.native, "
        "rfi_toolbox_tpu_torch.synth.generator, rfi_toolbox_tpu_torch.train.raw_patches, "
        "rfi_toolbox_tpu_torch.synth.simulator, rfi_toolbox_tpu_torch.train.coherent_trainer, "
        "rfi_toolbox_tpu_torch.io.flagging, rfi_toolbox_tpu_torch.models.instance, "
        "rfi_toolbox_tpu_torch.train.instance_trainer, rfi_toolbox_tpu_torch.evaluation.instances\n"
        "from rfi_toolbox_tpu_torch.synth import RFISimulator\n"
        "from rfi_toolbox_tpu_torch.train import CoherentTrainer, coherent_batch\n"
        "from rfi_toolbox_tpu_torch.io import flag_waterfalls_coherent\n"
        "from rfi_toolbox_tpu_torch.models import SOLOLite, matrix_nms, solo_decode, solo_loss\n"
        "from rfi_toolbox_tpu_torch.train import InstanceTrainer\n"
        "from rfi_toolbox_tpu_torch.evaluation import evaluate_instance_model, match_instances\n"
        "from rfi_toolbox_tpu_torch.synth import make_instance_sample_generator\n"
        "from rfi_toolbox_tpu_torch.io import (MSLoader, FakeMS, FakeTable, make_fake_ms, "
        "inject_synthetic_data, flag_measurement_set, CASA_AVAILABLE)\n"
        "from rfi_toolbox_tpu_torch.evaluation import (compute_mad, compute_statistics, "
        "compute_ffi, compute_calcquality, print_statistics_comparison)\n"
        "from rfi_toolbox_tpu_torch.data import RFIMaskDataset\n"
        "import rfi_toolbox_tpu_torch.io.ms_loader, rfi_toolbox_tpu_torch.io.ms_injection, "
        "rfi_toolbox_tpu_torch.io.fake_ms, rfi_toolbox_tpu_torch.evaluation.statistics, "
        "rfi_toolbox_tpu_torch.data.rfi_mask_dataset\n"
        "import rfi_toolbox_tpu_torch.cli, rfi_toolbox_tpu_torch.cli.generate_dataset, "
        "rfi_toolbox_tpu_torch.cli.normalize_data, rfi_toolbox_tpu_torch.cli.train_model, "
        "rfi_toolbox_tpu_torch.cli.evaluate_model, rfi_toolbox_tpu_torch.config, "
        "rfi_toolbox_tpu_torch.config.loader, rfi_toolbox_tpu_torch.config.validators, "
        "rfi_toolbox_tpu_torch.visualization, rfi_toolbox_tpu_torch.visualization.visualize, "
        "rfi_toolbox_tpu_torch.core, rfi_toolbox_tpu_torch.preprocessing, "
        "rfi_toolbox_tpu_torch.datasets, rfi_toolbox_tpu_torch.data_generation, "
        "rfi_toolbox_tpu_torch.scripts, rfi_toolbox_tpu_torch.utils.errors, "
        "rfi_toolbox_tpu_torch.utils.profiling\n"
        "from rfi_toolbox_tpu_torch.config import ConfigLoader, TrainingConfig, validate_all\n"
        "from rfi_toolbox_tpu_torch.utils import StepTimer, trace, annotate, ConfigValidationError\n"
        "import rfi_toolbox_tpu_torch.parallel, rfi_toolbox_tpu_torch.parallel.mesh, "
        "rfi_toolbox_tpu_torch.parallel.spatial, rfi_toolbox_tpu_torch.parallel.distributed, "
        "rfi_toolbox_tpu_torch.parallel.functional\n"
        "from rfi_toolbox_tpu_torch.parallel import (make_mesh, replicated, batch_sharding, "
        "shard_batch, shard_params_tensor_parallel, shard_waterfalls, initialize_distributed, "
        "global_mesh, process_info)\n"
        "from rfi_toolbox_tpu_torch.parallel.spatial import preprocess_sharded, "
        "sharded_global_stats\n"
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
    assert {p.name for p in sources} >= {"mad_flags.cu", "channel_planes.cu",
                                         "plane_gather.cu", "conv3x3.cu",
                                         "conv3x3_mma.cuh", "mma_tf32.cuh",
                                         "double_conv_gn.cu", "extract_strips.cu"}
    assert not (PORT / "ops" / "csrc" / "conv3x3_tile.cuh").exists()  # K6a's FMA tile
    # K4 is an instance of K1's and K2's cluster kernel
    assert not (PORT / "ops" / "csrc" / "fused_channels.cu").exists()
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
    from rfi_toolbox_tpu_torch.preprocess import Preprocessor
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor
    from rfi_toolbox_tpu_torch.synth import make_sample_generator
    from rfi_toolbox_tpu_torch.train import Trainer, create_train_state
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Preprocessor(vis).create_dataset(patch_size=8, static_num_patches=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sample_generator(16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(UNet(init_features=2, depth=2), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(UNet(init_features=2, depth=2))
    assert resolve_device("cpu") == torch.device("cpu")
    assert flag_waterfalls(vis, device="cpu").shape == (1, 16, 16)
    ds = Preprocessor(vis, device="cpu").create_dataset(
        patch_size=8, static_num_patches=4, use_custom_flags=False)
    assert ds.images.shape == (4, 8, 8, 3)
    fn = make_sample_generator(16, 16, device="cpu")
    assert fn(1, torch.Generator().manual_seed(0))[0].shape == (1, 1, 16, 16)
    state = create_train_state(UNet(init_features=2, depth=2), 0, device="cpu")
    assert state.device == torch.device("cpu")


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
