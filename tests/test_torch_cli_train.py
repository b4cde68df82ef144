"""The port's ``train_rfi_model`` and ``evaluate_rfi_model`` end to end on
the CPU at 32-64², ``init_features`` 4, float32, and ``evaluate_model``
against the JAX package's.

- ``evaluate_model``: a UNet of width 4 on 8 channels from JAX's initial
  parameters, exported by JAX's ``export_params``, evaluated by both
  packages on a 64² sample-dir dataset, with and without TTA, the
  threshold from the snapshot's metadata: every metric within 1e-5.
- the semantic path: 2 epochs; the result has the keys of JAX's; the
  checkpoints are written; ``--checkpoint_path`` and ``--auto_resume``
  continue the epoch count.
- ``--coherent`` and ``--instance``: 4 steps with a checkpoint every 2,
  then ``--auto_resume`` to 6, which restores ``step_4.pt`` (the port's
  checkpoints are files; JAX's command globs Orbax directories and would
  find none of them); ``--export``, then ``evaluate_rfi_model`` on the
  snapshot, equal to the library calls it wraps.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from rfi_toolbox_tpu.cli.evaluate_model import evaluate_model as jax_evaluate_model
from rfi_toolbox_tpu.cli.train_model import main as jax_train_main
from rfi_toolbox_tpu.models import UNet as FlaxUNet
from rfi_toolbox_tpu.train import export_params as jax_export_params
from rfi_toolbox_tpu_torch.cli.evaluate_model import evaluate_model
from rfi_toolbox_tpu_torch.cli.evaluate_model import main as eval_main
from rfi_toolbox_tpu_torch.cli.generate_dataset import main as generate_main
from rfi_toolbox_tpu_torch.cli.normalize_data import main as normalize_main
from rfi_toolbox_tpu_torch.cli.train_model import main as train_main
from rfi_toolbox_tpu_torch.evaluation import evaluate_instance_model
from rfi_toolbox_tpu_torch.train import CoherentTrainer, InstanceTrainer, load_params

METRIC_TOL = 1e-5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """3 + 2 samples at 32², and the validation split at 64²
    robust-scaled (a snapshot's input of moderate size)."""
    root = tmp_path_factory.mktemp("cli_ds")
    generate_main(["--samples_training", "3", "--samples_validation", "2",
                   "--output_dir", str(root / "d32"), "--time_bins", "32",
                   "--frequency_bins", "32", "--seed", "2", "--batch_size", "2",
                   "--device", "cpu"])
    generate_main(["--samples_training", "1", "--samples_validation", "3",
                   "--output_dir", str(root / "d64"), "--time_bins", "64",
                   "--frequency_bins", "64", "--seed", "5", "--device", "cpu"])
    normalize_main(["--input_dir", str(root / "d64" / "val"), "--output_dir",
                    str(root / "val64"), "--normalization", "robust_scale"])
    return root


def test_evaluate_model_matches_jax(dataset, tmp_path):
    model = FlaxUNet(init_features=4)
    v = model.init(jax.random.key(0), np.zeros((1, 64, 64, 8), np.float32), train=False)
    snap = tmp_path / "unet4.npz"
    jax_export_params(v["params"], snap, batch_stats=v["batch_stats"],
                      metadata={"init_features": 4, "best_threshold": 0.3})
    val = str(dataset / "val64")
    for tta in (False, True):
        want = jax_evaluate_model(str(snap), val, batch_size=2, tta=tta)
        got = evaluate_model(str(snap), val, batch_size=2, tta=tta, device="cpu")
        assert got.keys() == want.keys() == {"iou", "precision", "recall", "f1", "dice"}
        for k in want:
            assert abs(got[k] - want[k]) <= METRIC_TOL, (tta, k, got[k], want[k])
    # the metadata's threshold is used: an explicit 0.3 gives the same numbers
    assert evaluate_model(str(snap), val, batch_size=2, threshold=0.3, device="cpu") == \
        evaluate_model(str(snap), val, batch_size=2, device="cpu")


def _semantic_args(dataset, ck):
    return ["--train_dir", str(dataset / "d32" / "train"), "--val_dir",
            str(dataset / "d32" / "val"), "--batch_size", "2", "--init_features", "4",
            "--compute_dtype", "float32", "--checkpoint_dir", str(ck)]


def test_train_cli_semantic_end_to_end(dataset, tmp_path):
    args = _semantic_args(dataset, tmp_path / "ck")
    want = jax_train_main(_semantic_args(dataset, tmp_path / "jax_ck") + ["--num_epochs", "1"])
    r1 = train_main(args + ["--num_epochs", "2", "--lr", "1e-3", "--augment",
                            "--device", "cpu"])
    assert r1.keys() == want.keys()
    assert r1["epochs_run"] == 2 and [h["epoch"] for h in r1["history"]] == [1, 2]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in r1["history"])
    final = Path(r1["final_checkpoint"])
    assert final.name == "unet_rfi_final.pt" and final.exists()
    assert Path(r1["best_checkpoint"]).exists()

    r2 = train_main(args + ["--num_epochs", "3", "--checkpoint_path", str(final),
                            "--new_lr", "5e-4", "--device", "cpu"])
    assert [h["epoch"] for h in r2["history"]] == [3]
    r3 = train_main(args + ["--num_epochs", "4", "--auto_resume", "--device", "cpu"])
    assert [h["epoch"] for h in r3["history"]] == [4]  # from r2's final (epoch 3)

    metrics = evaluate_model(r3["final_checkpoint"], str(dataset / "d32" / "val"),
                             batch_size=2, init_features=4, device="cpu")
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
    out = eval_main(["--model_path", r3["final_checkpoint"], "--dataset_dir",
                     str(dataset / "d32" / "val"), "--batch_size", "2",
                     "--init_features", "4", "--device", "cpu"])
    assert out == metrics


def _spy_restore(monkeypatch, cls):
    seen = []
    original = cls.restore_checkpoint

    def restore(self, path, *args, **kwargs):
        step = original(self, path, *args, **kwargs)
        seen.append((Path(path).name, step))
        return step

    monkeypatch.setattr(cls, "restore_checkpoint", restore)
    return seen


def _assert_resumable_files(ck, steps):
    names = sorted(p.name for p in ck.iterdir())
    assert names == sorted(f"step_{s}.pt" for s in steps)
    # JAX's command keeps only step_* directories: it would resume from none of these
    assert [p for p in ck.glob("step_*") if p.is_dir()] == []


def test_train_cli_coherent_resume_export_evaluate(tmp_path, monkeypatch):
    snap, ck = tmp_path / "coh.npz", tmp_path / "ck"
    flags = ["--coherent", "--fused_steps", "2", "--size", "32", "--batch_size", "2",
             "--init_features", "4", "--norm", "group", "--checkpoint_dir", str(ck),
             "--checkpoint_every", "2", "--log_every", "2", "--eval_batches", "1",
             "--seed", "0", "--device", "cpu"]
    res = train_main(flags + ["--num_steps", "4", "--export", str(snap)])
    assert res["steps"] == 4 and res.keys() == {"steps", "eval", "export"}
    _assert_resumable_files(ck, [2, 4])
    assert 0.0 <= res["eval"]["best_iou"] <= 1.0
    meta = load_params(snap)[2]
    assert (meta["init_features"], meta["norm"], meta["steps"]) == (4, "group", 4)
    assert meta["best_threshold"] == res["eval"]["best_threshold"]

    seen = _spy_restore(monkeypatch, CoherentTrainer)
    res2 = train_main(flags + ["--num_steps", "6", "--auto_resume"])
    assert seen == [("step_4.pt", 4)] and res2["steps"] == 6
    _assert_resumable_files(ck, [2, 4, 6])

    out = eval_main(["--model_path", str(snap), "--coherent", "--num_images", "2",
                     "--batch_size", "2", "--device", "cpu"])
    direct = CoherentTrainer.load(snap, device="cpu").evaluate(num_batches=1, eval_batch=2)
    assert out == direct


def test_train_cli_instance_resume_export_evaluate(tmp_path, monkeypatch):
    snap, ck = tmp_path / "solo.npz", tmp_path / "ck"
    flags = ["--instance", "--fused_steps", "2", "--patch_size", "32", "--batch_size", "2",
             "--init_features", "8", "--grid_size", "4", "--checkpoint_dir", str(ck),
             "--checkpoint_every", "2", "--log_every", "2", "--seed", "0", "--device", "cpu"]
    res = train_main(flags + ["--num_steps", "4", "--eval_images", "2", "--export", str(snap)])
    assert res["steps"] == 4 and res.keys() == {"steps", "history", "eval", "export"}
    assert [h["step"] for h in res["history"]] == [2, 2]  # each fit call counts from 0
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    _assert_resumable_files(ck, [2, 4])
    meta = load_params(snap)[2]
    assert (meta["features"], meta["grid_size"], meta["patch_size"]) == (8, 4, 32)

    seen = _spy_restore(monkeypatch, InstanceTrainer)
    res2 = train_main(flags + ["--num_steps", "6", "--eval_images", "0", "--auto_resume"])
    assert seen == [("step_4.pt", 4)]
    assert res2["steps"] == 6 and len(res2["history"]) == 1 and "eval" not in res2
    _assert_resumable_files(ck, [2, 4, 6])

    out = eval_main(["--model_path", str(snap), "--instance", "--num_images", "2",
                     "--batch_size", "2", "--device", "cpu"])
    direct = evaluate_instance_model(InstanceTrainer.load(snap, batch_size=2, device="cpu"),
                                     num_images=2, seed=10_000)
    assert out == direct
    for bad in (["--tta"], ["--threshold", "0.3"], ["--coherent"]):
        with pytest.raises(SystemExit):
            eval_main(["--model_path", str(snap), "--instance", "--device", "cpu"] + bad)
