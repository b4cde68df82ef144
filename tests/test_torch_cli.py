"""Port parity of the command-line layer: ``normalize_rfi_data``,
``generate_rfi_dataset`` and ``train_rfi_model``'s argument resolution,
against the JAX package's commands, on the CPU.

- normalize: every method's files bit-equal to JAX's, and the same lines
  printed.
- generate at 64², seed 1, 3 + 2 samples: the same file tree, shapes and
  dtypes as JAX's; the port's files bit-equal to its generator called
  directly; RFI checked by structure (``jax.random`` and
  ``torch.Generator`` streams differ), clean planes by statistics.
- argument resolution: both ``main``s run with the trainers, the model
  factories and the dataset loaders replaced by recorders (nothing
  trains); every argv case records the same constructor and ``fit``
  arguments, the instance schedule compared by value (1e-6 relative).
- ``--mesh_shape``: JAX's data-only message for ``--coherent``; in this
  (one) process any shape whose product is not 1 refused; a product
  equal to the world size runs (``test_torch_parallel_cli.py``).
- with no card, every command but the host-only normalize raises unless
  ``--device cpu`` is given.
"""

import logging
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import rfi_toolbox_tpu.data as jax_data
import rfi_toolbox_tpu.evaluation as jax_evaluation
import rfi_toolbox_tpu.models as jax_models
import rfi_toolbox_tpu.models.instance as jax_instance
import rfi_toolbox_tpu.train as jax_train
from rfi_toolbox_tpu.cli import generate_dataset as jax_generate
from rfi_toolbox_tpu.cli import normalize_data as jax_normalize
from rfi_toolbox_tpu.cli import train_model as jax_train_cli
from rfi_toolbox_tpu_torch.cli import evaluate_model as port_evaluate
from rfi_toolbox_tpu_torch.cli import generate_dataset as port_generate
from rfi_toolbox_tpu_torch.cli import normalize_data as port_normalize
from rfi_toolbox_tpu_torch.cli import train_model as port_train_cli
from rfi_toolbox_tpu_torch.synth import RFISimulator
from rfi_toolbox_tpu_torch.visualization import visualize as port_visualize

ROOT = Path(__file__).resolve().parents[1]
GEN_ARGS = ["--samples_training", "3", "--samples_validation", "2", "--time_bins", "64",
            "--frequency_bins", "64", "--seed", "1", "--batch_size", "2"]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


# -- normalize_rfi_data ------------------------------------------------------------------


@pytest.fixture
def raw_tree(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "raw"
    for i, sub in enumerate(["0000", "0001", "nested/0002"]):
        d = root / sub
        d.mkdir(parents=True)
        x = rng.normal(2.0, 3.0, (8, 16, 12)).astype(np.float32)
        x[:, :2] += 1e4 * rng.random((8, 2, 12)).astype(np.float32)  # heavy RFI rows
        np.save(d / "input.npy", x)
        np.save(d / "rfi_mask.npy", rng.random((16, 12)) < 0.1)
    np.save(root / "0001" / "other.npy", np.zeros(3))  # neither input nor mask
    (root / "broken").mkdir()
    (root / "broken" / "input.npy").write_bytes(b"not an npy file")
    return root


@pytest.mark.parametrize("method", ["standardize", "robust_scale", "global_min_max", "none",
                                    "None"])
def test_normalize_cli_matches_jax(raw_tree, tmp_path, capsys, method):
    out = {}
    for name, mod in (("jax", jax_normalize), ("port", port_normalize)):
        out[name] = tmp_path / name
        mod.main(["--input_dir", str(raw_tree), "--output_dir", str(out[name]),
                  "--normalization", method])
        out[name + "_text"] = capsys.readouterr().out.replace(str(out[name]), "<out>")
    assert out["port_text"] == out["jax_text"]
    assert "Processed 3/4 input files" in out["port_text"]  # the broken file is reported
    assert _files(out["port"]) == _files(out["jax"])
    for rel in _files(out["jax"]):
        a, b = np.load(out["port"] / rel), np.load(out["jax"] / rel)
        assert a.dtype == b.dtype and np.array_equal(a, b), rel


@pytest.mark.parametrize("case", ["gauss", "constant", "float64", "ints", "two_values"])
@pytest.mark.parametrize("method", ["standardize", "robust_scale", "global_min_max", None])
def test_normalize_array_matches_jax(case, method):
    rng = np.random.default_rng(5)
    x = {"gauss": rng.normal(1.0, 2.0, (8, 9, 7)).astype(np.float32),
         "constant": np.full((8, 4, 4), 3.5, np.float32),
         "float64": rng.normal(0.0, 1.0, (5, 5)),
         "ints": rng.integers(-5, 50, (6, 6)),
         "two_values": np.array([0.0, 0.0, 0.0, 1.0], np.float32)}[case]
    got, want = port_normalize.normalize_array(x, method), jax_normalize.normalize_array(x, method)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if method is None:
        assert got is x


def test_normalize_array_rejects_unknown_method():
    with pytest.raises(ValueError, match="Unsupported normalization method: l2"):
        port_normalize.normalize_array(np.ones(3), "l2")


# -- generate_rfi_dataset ----------------------------------------------------------------


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    root = tmp_path_factory.mktemp("generated")
    jax_generate.main(GEN_ARGS + ["--output_dir", str(root / "jax")])
    port_generate.main(GEN_ARGS + ["--output_dir", str(root / "port"), "--device", "cpu"])
    return root


def test_generate_tree_shapes_and_dtypes_match_jax(generated):
    jax_files, port_files = _files(generated / "jax"), _files(generated / "port")
    assert port_files == jax_files
    assert port_files[0] == "train/0000/input.npy" and len(port_files) == 10
    for rel in jax_files:
        a, b = np.load(generated / "port" / rel), np.load(generated / "jax" / rel)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), rel
    assert np.load(generated / "port/train/0000/input.npy").shape == (8, 64, 64)


def test_generate_rfi_by_structure(generated):
    for rel in _files(generated / "port"):
        x = np.load(generated / "port" / rel)
        if rel.endswith("rfi_mask.npy"):
            assert x.dtype == bool and x.any() and not x.all(), rel
        else:
            assert np.isfinite(x).all() and x.dtype == np.float32, rel
            assert np.abs(x).max() > 100  # RFI far above the unit noise
    # the validation split continues the stream (JAX's starts it again)
    a = np.load(generated / "port/train/0000/input.npy")
    assert not np.array_equal(a, np.load(generated / "port/val/0000/input.npy"))


def test_generate_files_equal_the_generator_called_directly(generated):
    sim = RFISimulator(64, 64, seed=1, device="cpu")
    for split, batches in (("train", [2, 1]), ("val", [2])):
        i = 0
        for b in batches:
            tf, masks = sim.generate_rfi_device(b)
            for k in range(b):
                d = generated / "port" / split / f"{i:04d}"
                want = torch.view_as_real(tf[k]).permute(0, 3, 1, 2).reshape(8, 64, 64)
                assert np.array_equal(np.load(d / "input.npy"), want.numpy())
                assert np.array_equal(np.load(d / "rfi_mask.npy"), masks[k].numpy())
                i += 1


def test_generate_only_clean_by_statistics(tmp_path):
    args = ["--samples_training", "2", "--only_clean", "--time_bins", "64",
            "--frequency_bins", "64", "--seed", "4"]
    jax_generate.main(args + ["--output_dir", str(tmp_path / "jax")])
    port_generate.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "train/0000/input.npy", "train/0000/rfi_mask.npy",
        "train/0001/input.npy", "train/0001/rfi_mask.npy"]
    for i in range(2):
        d = f"train/{i:04d}"
        pm, jm = (np.load(tmp_path / w / d / "rfi_mask.npy") for w in ("port", "jax"))
        assert pm.dtype == jm.dtype == bool and not pm.any() and not jm.any()
        px, jx = (np.load(tmp_path / w / d / "input.npy") for w in ("port", "jax"))
        assert px.shape == jx.shape == (8, 64, 64) and px.dtype == jx.dtype
        # unit complex Gaussians: each part N(0, 1); 4096 values a channel
        for c in range(8):
            assert abs(px[c].mean()) < 0.08 and abs(px[c].std() - 1.0) < 0.05
            assert abs(px[c].std() - jx[c].std()) < 0.07
    seeded = tmp_path / "again"
    port_generate.main(args + ["--output_dir", str(seeded), "--device", "cpu"])
    assert np.array_equal(np.load(seeded / "train/0001/input.npy"),
                          np.load(tmp_path / "port/train/0001/input.npy"))


def test_generate_use_ms_arguments_match_jax(tmp_path, monkeypatch, caplog):
    calls = {"jax": [], "port": []}

    def recorder(log):
        class Recorded:
            def __init__(self, **kwargs):
                kwargs.pop("device", None)
                log.append(kwargs)

            def __len__(self):
                return 3
        return Recorded

    monkeypatch.setattr(jax_data, "RFIMaskDataset", recorder(calls["jax"]))
    monkeypatch.setattr(port_generate, "RFIMaskDataset", recorder(calls["port"]))
    argv = ["--use_ms", "--ms_name", "obs.ms", "--train_field", "0", "--val_field", "1"]
    jax_generate.main(argv + ["--output_dir", str(tmp_path / "jax")])
    port_generate.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    for c in calls["jax"] + calls["port"]:
        c["data_dir"] = os.path.relpath(c["data_dir"], tmp_path).split(os.sep, 1)[1]
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2
    assert calls["port"][1] == {"data_dir": "ms_data", "use_ms": True, "ms_name": "obs.ms",
                                "field_selection": 1}
    for bad in (["--use_ms"], ["--use_ms", "--ms_name", "x.ms", "--only_clean"]):
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            assert port_generate.main(bad + ["--device", "cpu"]) is None
        port_errors = [r.getMessage() for r in caplog.records if r.levelno == logging.ERROR]
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            assert jax_generate.main(bad) is None
        jax_errors = [r.getMessage() for r in caplog.records if r.levelno == logging.ERROR]
        assert port_errors == jax_errors and len(port_errors) == 1
    assert len(calls["port"]) == 2


# -- train_rfi_model: argument resolution ------------------------------------------------


class _Dataset:
    """A stand-in dataset: 2 images of 8 x 8 x 8, tagged with its path."""

    def __init__(self, tag):
        self.tag = tag
        self.images = np.zeros((2, 8, 8, 8), np.float32)
        self.labels = np.zeros((2, 8, 8), np.uint8)
        self.files = ["a", "b"]
        self.image_shape = (8, 8, 8)

    def __len__(self):
        return 2


def _recorders(log):
    """Recording stand-ins for what ``main`` builds: nothing trains."""

    def note(kind, args, kwargs):
        log.append((kind, args, dict(kwargs)))

    class Trainer:
        def __init__(self, *args, **kwargs):
            note("Trainer", args, kwargs)

        def fit(self, *args, **kwargs):
            note("Trainer.fit", args, kwargs)
            return {"history": [{"epoch": 1, "train_loss": 0.5, "val_loss": 0.4}],
                    "best_val_loss": 0.4, "final_checkpoint": "final", "best_checkpoint": None,
                    "epochs_run": 1}

    class CoherentTrainer:
        def __init__(self, *args, **kwargs):
            note("CoherentTrainer", args, kwargs)
            self.step, self.batch_size = 0, kwargs["batch_size"]

        def restore_checkpoint(self, path, **kwargs):
            note("CoherentTrainer.restore_checkpoint", (Path(path).name,), kwargs)

        def fit(self, num_steps, **kwargs):
            note("CoherentTrainer.fit", (num_steps,), kwargs)
            self.step += num_steps
            return {"history": []}

        def evaluate(self, **kwargs):
            note("CoherentTrainer.evaluate", (), kwargs)
            return {"best_iou": 0.5, "best_threshold": 0.45, "ious": {0.45: 0.5}}

        def export(self, path, **kwargs):
            note("CoherentTrainer.export", (path,), kwargs)

    class InstanceTrainer:
        def __init__(self, *args, **kwargs):
            note("InstanceTrainer", args, kwargs)
            self.step = 0

        def restore_checkpoint(self, path):
            note("InstanceTrainer.restore_checkpoint", (Path(path).name,), {})

        def fit(self, **kwargs):
            note("InstanceTrainer.fit", (), kwargs)
            self.step += kwargs["num_steps"]
            return {"history": [{"step": kwargs["num_steps"], "loss": 1.0, "cate_loss": 0.5,
                                 "mask_loss": 0.5, "steps_per_sec": 1.0}]}

        def save_checkpoint(self, path):
            note("InstanceTrainer.save_checkpoint", (Path(path).name.removesuffix(".pt"),), {})

        def save(self, path):
            note("InstanceTrainer.save", (path,), {})

    def create_model(*args, **kwargs):
        note("create_model", args, kwargs)
        return _Dataset("<model>")

    def sololite(*args, **kwargs):
        note("SOLOLite", args, kwargs)
        return _Dataset("<sololite>")

    def load_sample_dir_dataset(*args, **kwargs):
        kwargs.pop("device", None)
        note("load_sample_dir_dataset", args, kwargs)
        return _Dataset(args[0])

    def streaming(directory):
        note("StreamingDataset", (directory,), {})
        return _Dataset(directory)

    def evaluate_instance_model(trainer, **kwargs):
        note("evaluate_instance_model", (), kwargs)
        return {"recall": 0.5, "precision": 0.5}

    return {"Trainer": Trainer, "CoherentTrainer": CoherentTrainer,
            "InstanceTrainer": InstanceTrainer, "create_model": create_model,
            "SOLOLite": sololite, "load_sample_dir_dataset": load_sample_dir_dataset,
            "StreamingDataset": streaming, "evaluate_instance_model": evaluate_instance_model}


def _patch_jax(monkeypatch, fakes):
    for name in ("Trainer", "CoherentTrainer", "InstanceTrainer"):
        monkeypatch.setattr(jax_train, name, fakes[name])
    monkeypatch.setattr(jax_models, "create_model", fakes["create_model"])
    monkeypatch.setattr(jax_instance, "SOLOLite", fakes["SOLOLite"])
    monkeypatch.setattr(jax_data, "StreamingDataset", fakes["StreamingDataset"])
    monkeypatch.setattr(jax_evaluation, "evaluate_instance_model",
                        fakes["evaluate_instance_model"])
    monkeypatch.setattr(jax_train_cli, "load_sample_dir_dataset",
                        fakes["load_sample_dir_dataset"])


def _patch_port(monkeypatch, fakes):
    for name, fake in fakes.items():
        monkeypatch.setattr(port_train_cli, name, fake)


SCHEDULE_AT = (0, 1, 250, 499, 500, 501, 18_000, 35_999, 36_000, 40_000)


def _canon(kind, kwargs, port):
    """Comparable constructor/fit arguments: drop what differs by design
    (JAX's mesh, the port's device and the data's channel count) and
    turn dtypes, callables and schedules into values."""
    kwargs = dict(kwargs)
    for key in ("mesh", "mesh_shape", "device"):
        kwargs.pop(key, None)
    if kind == "create_model" and port:
        assert kwargs.pop("in_channels") == 8  # the data's channels
    for key, value in list(kwargs.items()):
        if key == "dtype":
            kwargs[key] = (str(value).removeprefix("torch.") if isinstance(value, torch.dtype)
                           else np.dtype(value).name)
        elif key == "learning_rate" and callable(value):
            kwargs[key] = [float(value(s)) for s in SCHEDULE_AT]
        elif key == "callback":
            kwargs[key] = "<callable>"
        elif hasattr(value, "tag"):
            kwargs[key] = value.tag
        elif isinstance(value, Path):
            kwargs[key] = str(value)
    return kwargs


def _run_both(monkeypatch, argv):
    logs = {"jax": [], "port": []}
    results = {}
    with monkeypatch.context() as m:
        _patch_jax(m, _recorders(logs["jax"]))
        results["jax"] = jax_train_cli.main(argv)
    with monkeypatch.context() as m:
        _patch_port(m, _recorders(logs["port"]))
        results["port"] = port_train_cli.main(argv)
    return logs, results


def _assert_same_calls(logs):
    jax_log, port_log = logs["jax"], logs["port"]
    assert [k for k, _, _ in port_log] == [k for k, _, _ in jax_log]
    for (kind, ja, jk), (_, pa, pk) in zip(jax_log, port_log):
        ja = tuple(a.tag if hasattr(a, "tag") else a for a in ja)
        pa = tuple(a.tag if hasattr(a, "tag") else a for a in pa)
        assert pa == ja, kind
        jk, pk = _canon(kind, jk, port=False), _canon(kind, pk, port=True)
        if "learning_rate" in jk and isinstance(jk["learning_rate"], list):
            assert pk.pop("learning_rate") == pytest.approx(jk.pop("learning_rate"), rel=1e-6)
        assert pk == jk, kind


ARGV_CASES = {
    "defaults": [],
    "config": ["--config", "configs/training/unet_default.yaml"],
    "config_explicit": ["--config", "configs/training/unet_default.yaml", "--batch_size", "8",
                        "--lr", "3e-4"],
    "resume_new_lr": ["--checkpoint_path", "ck/unet_rfi_final.pt", "--new_lr", "5e-4",
                      "--num_epochs", "7"],
    "auto_resume_flags": ["--auto_resume", "--model_type", "unet_bigger", "--norm", "group",
                          "--compute_dtype", "float32", "--seed", "3", "--weight_decay", "0"],
    "coherent": ["--coherent"],
    "coherent_explicit": ["--coherent", "--lr", "2e-4", "--batch_size", "4", "--size", "64",
                          "--num_steps", "50", "--fused_steps", "5", "--checkpoint_every", "20",
                          "--export", "coh.npz"],
    "coherent_config": ["--coherent", "--config", "configs/training/unet_default.yaml"],
    "instance": ["--instance"],
    "instance_explicit": ["--instance", "--lr", "1e-3", "--batch_size", "8",
                          "--init_features", "16", "--num_steps", "30",
                          "--checkpoint_every", "10", "--eval_images", "0",
                          "--space_to_depth", "--export", "solo.npz"],
    "instance_short": ["--instance", "--num_steps", "12", "--checkpoint_every", "5",
                       "--grid_size", "4", "--event_config",
                       "configs/evaluation/all_six_events.yaml"],
    "streaming": ["--train_batches_dir", "batches/train", "--val_batches_dir", "batches/val",
                  "--augment", "--batch_size", "16"],
    "mesh_one": ["--mesh_shape", "1,1"],
}


@pytest.mark.parametrize("case", sorted(ARGV_CASES))
def test_train_arguments_resolve_alike(monkeypatch, tmp_path, case):
    monkeypatch.chdir(ROOT)
    argv = ARGV_CASES[case] + ["--train_dir", "data/train", "--val_dir", "data/val",
                               "--checkpoint_dir", str(tmp_path / "ck"), "--device", "cpu"]
    logs, results = _run_both(monkeypatch, argv)
    _assert_same_calls(logs)
    kinds = [k for k, _, _ in logs["port"]]
    assert kinds[-1] in ("Trainer.fit", "CoherentTrainer.evaluate", "InstanceTrainer.save",
                         "InstanceTrainer.save_checkpoint", "evaluate_instance_model",
                         "CoherentTrainer.export")
    assert results["port"].keys() == results["jax"].keys()
    if case == "config_explicit":
        trainer = [k for n, _, k in logs["port"] if n == "Trainer"][0]
        fit = [k for n, _, k in logs["port"] if n == "Trainer.fit"][0]
        assert trainer["learning_rate"] == 3e-4 and fit["batch_size"] == 8
        assert fit["num_epochs"] == 50  # the YAML's
    if case == "instance":
        sched = [k for n, _, k in logs["port"] if n == "InstanceTrainer"][0]["learning_rate"]
        assert [sched(0), sched(500), sched(36_000)] == pytest.approx([1e-5, 8e-4, 1e-5], rel=1e-5)


def test_mesh_shape_coherent_is_data_only_as_in_jax(tmp_path):
    for bad in ("2,2", "2,1,4", "1,1,2"):
        argv = ["--coherent", "--mesh_shape", bad, "--checkpoint_dir", str(tmp_path / "ck"),
                "--num_steps", "1", "--device", "cpu"]
        with pytest.raises(SystemExit) as jax_exit:
            jax_train_cli.main(argv)
        with pytest.raises(SystemExit, match="data-only") as port_exit:
            port_train_cli.main(argv)
        assert str(port_exit.value) == str(jax_exit.value)


@pytest.mark.parametrize("argv", [
    ["--mesh_shape", "2,1"],
    ["--mesh_shape", "4"],
    ["--coherent", "--mesh_shape", "2,1"],
    ["--instance", "--mesh_shape", "1,2"],
    ["--config", "configs/training/unet_dp_tp.yaml"],
], ids=["data2", "data4", "coherent", "instance", "dp_tp_yaml"])
def test_mesh_shape_beyond_one_device_is_refused(monkeypatch, tmp_path, argv):
    monkeypatch.chdir(ROOT)
    with monkeypatch.context() as m:
        _patch_port(m, _recorders(log := []))
        with pytest.raises(SystemExit, match=r"asks for \d+ devices but this run has 1 "):
            port_train_cli.main(argv + ["--checkpoint_dir", str(tmp_path), "--device", "cpu"])
    assert log == []  # refused before anything was built


def test_explicit_mesh_shape_beats_the_yaml(monkeypatch, tmp_path):
    monkeypatch.chdir(ROOT)
    with monkeypatch.context() as m:
        _patch_port(m, _recorders(log := []))
        port_train_cli.main(["--config", "configs/training/unet_dp_tp.yaml", "--mesh_shape", "1",
                             "--checkpoint_dir", str(tmp_path), "--device", "cpu"])
    model = [k for n, _, k in log if n == "create_model"][0]
    assert model["init_features"] == 32 and [n for n, _, _ in log][0:1] == [
        "load_sample_dir_dataset"]
    fit = [k for n, _, k in log if n == "Trainer.fit"][0]
    assert fit["batch_size"] == 64


def test_latest_step_checkpoint_finds_the_port_files(tmp_path):
    assert port_train_cli._latest_step_checkpoint(tmp_path / "missing") is None
    for n in (2, 10, 4):
        (tmp_path / f"step_{n}.pt").write_bytes(b"")
    (tmp_path / "step_x.pt").write_bytes(b"")
    (tmp_path / "step_99").mkdir()  # a JAX Orbax directory is not the port's
    assert port_train_cli._latest_step_checkpoint(tmp_path).name == "step_10.pt"


# -- no card: every command but the host-only normalize raises ---------------------------


@pytest.mark.parametrize("command", ["generate", "train", "evaluate", "visualize",
                                     "train_coherent", "train_instance",
                                     "evaluate_coherent", "evaluate_instance"])
def test_commands_want_the_card(tmp_path, command):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    main, argv = {
        "generate": (port_generate.main, ["--output_dir", str(tmp_path / "g"),
                                          "--samples_training", "1"]),
        "train": (port_train_cli.main, ["--train_dir", str(tmp_path)]),
        "train_coherent": (port_train_cli.main, ["--coherent"]),
        "train_instance": (port_train_cli.main, ["--instance"]),
        "evaluate": (port_evaluate.main, ["--model_path", "m.npz", "--dataset_dir",
                                          str(tmp_path)]),
        "evaluate_coherent": (port_evaluate.main, ["--model_path", "m.npz", "--coherent"]),
        "evaluate_instance": (port_evaluate.main, ["--model_path", "m.npz", "--instance"]),
        "visualize": (port_visualize.main, ["--dataset_dir", str(tmp_path)]),
    }[command]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--checkpoint_dir", str(tmp_path / "ck")] if "train" in command
             else argv)
    assert not (tmp_path / "g").exists() and not (tmp_path / "ck").exists()


def test_normalize_needs_no_device(raw_tree, tmp_path):
    port_normalize.main(["--input_dir", str(raw_tree), "--output_dir", str(tmp_path / "n")])
    assert (tmp_path / "n" / "0000" / "input.npy").exists()
