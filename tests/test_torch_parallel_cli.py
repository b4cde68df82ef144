"""``train_rfi_model --mesh_shape`` at the world size it is given: the
command under torchrun's environment (gloo ranks on the CPU), against the
same command without a mesh.

- ``--mesh_shape 2,1`` on 2 ranks: rank 0 writes the final checkpoint in
  the meshless format; its loss within 1e-5 of the meshless command's and
  its parameters within the trainers' tolerance
  (``test_torch_parallel_trainers.py``);
- ``--mesh_shape 1,1`` in a plain process (a process group of its own):
  the meshless checkpoint, bit for bit;
- ``--instance``/``--coherent --mesh_shape 2`` on 2 ranks: their step
  checkpoints against the meshless commands';
- ``--config configs/training/unet_dp_tp.yaml`` (4 x 2) on 8 ranks, cut
  to a small width and batch: it runs, and every rank's history is
  the same;
- a product other than the world size is refused on every rank, before
  anything is built.

Each launch is killed at 120 s.
"""

import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from rfi_toolbox_tpu_torch.cli.train_model import main as train_main
from rfi_toolbox_tpu_torch.data import ArrayDataset, BatchWriter

LR = 1e-3
CLI = ["-m", "rfi_toolbox_tpu_torch.cli.train_model"]


@contextlib.contextmanager
def _ranks_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """24 toy images of 32 x 32 (unet_bigger halves them five times) in
    batch files."""
    root = tmp_path_factory.mktemp("batches")
    images, labels = R.toy_images(seed=1)
    images = np.tile(images, (1, 2, 2, 1))
    labels = np.tile(labels, (1, 2, 2))
    w = BatchWriter(root, samples_per_batch=8)
    w.add_batch(ArrayDataset(images, labels))
    w.finalize()
    return root


def _semantic(batches, ck):
    return ["--train_batches_dir", str(batches), "--batch_size", "8", "--num_epochs", "1",
            "--lr", str(LR), "--init_features", "4", "--compute_dtype", "float32",
            "--checkpoint_dir", str(ck), "--device", "cpu"]


def _meshless(argv):
    with _ranks_threads():
        return train_main(argv)


def _ok(results):
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank}:\n{out[-4000:]}"


def _close(got, want):
    diff = torch.cat([(g.double() - w.double()).abs().flatten() for g, w in zip(got, want)])
    assert float(diff.max()) <= LR / 2 and float((diff <= LR / 100).double().mean()) >= 0.99


def _params(tree):
    return [v for k, v in tree["model"].items() if "running" not in k and "num_batches" not in k]


def test_mesh_shape_2x1_runs_on_two_ranks(batches, tmp_path):
    _ok(R.run_torchrun(CLI + _semantic(batches, tmp_path / "mesh") + ["--mesh_shape", "2,1"], 2))
    want = _meshless(_semantic(batches, tmp_path / "plain"))
    got = torch.load(tmp_path / "mesh" / "unet_rfi_final.pt", weights_only=True)
    ref = torch.load(want["final_checkpoint"], weights_only=True)
    assert got["model"].keys() == ref["model"].keys() and got["step"] == ref["step"] == 3
    assert got["loss"] == pytest.approx(ref["loss"], abs=1e-5)
    _close(_params(got), _params(ref))


def test_mesh_shape_1x1_runs_in_a_plain_process(batches, tmp_path):
    proc = subprocess.run([sys.executable, *CLI, *_semantic(batches, tmp_path / "mesh"),
                           "--mesh_shape", "1,1"],
                          cwd=R.ROOT, env=R.worker_env(), capture_output=True, text=True,
                          timeout=R.TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = _meshless(_semantic(batches, tmp_path / "plain"))
    got = torch.load(tmp_path / "mesh" / "unet_rfi_final.pt", weights_only=True)
    ref = torch.load(want["final_checkpoint"], weights_only=True)
    assert got["loss"] == ref["loss"]
    for a, b in zip(_params(got), _params(ref)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["--instance", "--coherent"])
def test_recipes_on_a_data_mesh_of_two(mode, tmp_path):
    flags = [mode, "--num_steps", "2", "--batch_size", "4", "--init_features", "4",
             "--lr", str(LR), "--fused_steps", "1", "--checkpoint_every", "2",
             "--log_every", "1", "--seed", "0", "--device", "cpu"]
    flags += (["--patch_size", "32", "--grid_size", "4", "--eval_images", "0"]
              if mode == "--instance" else ["--size", "32", "--eval_batches", "1"])
    _ok(R.run_torchrun(CLI + flags + ["--mesh_shape", "2", "--checkpoint_dir",
                                      str(tmp_path / "mesh")], 2))
    _meshless(flags + ["--checkpoint_dir", str(tmp_path / "plain")])
    got = torch.load(tmp_path / "mesh" / "step_2.pt", weights_only=True)
    ref = torch.load(tmp_path / "plain" / "step_2.pt", weights_only=True)
    assert got["step"] == ref["step"] == 2
    _close(_params(got), _params(ref))
    _close(got["mu"], ref["mu"])


def test_dp_tp_yaml_runs_on_eight_ranks(batches, tmp_path):
    """configs/training/unet_dp_tp.yaml's (4, 2) mesh and unet_bigger, cut
    to init_features 2 and a batch of 8 on 32 x 32 images."""
    results = R.run_torchrun(CLI + [
        "--config", "configs/training/unet_dp_tp.yaml", "--train_batches_dir", str(batches),
        "--init_features", "2", "--batch_size", "8", "--num_epochs", "1",
        "--compute_dtype", "float32", "--checkpoint_dir", str(tmp_path), "--device", "cpu"], 8)
    _ok(results)
    lines = [[ln for ln in out.splitlines() if ln.startswith("Epoch 1 - train")]
             for _, out in results]
    assert all(len(x) == 1 and x == lines[0] for x in lines), lines
    assert "mesh: data=4 x model=2" in results[0][1]
    tree = torch.load(tmp_path / "unet_rfi_final.pt", weights_only=True)
    assert np.isfinite(tree["loss"]) and tree["step"] == 3


def test_mesh_shape_beyond_the_world_is_refused_on_every_rank(batches, tmp_path):
    results = R.run_torchrun(CLI + _semantic(batches, tmp_path) + ["--mesh_shape", "4,1"], 2)
    for rc, out in results:
        assert rc != 0
        assert "--mesh_shape 4,1 asks for 4 devices but this run has 2" in out
    assert not tmp_path.exists() or not any(tmp_path.iterdir())
