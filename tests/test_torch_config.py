"""Port parity: the config loader and validators, the profiling helpers,
the reference-path aliases and ``CompiledPredictor.cost_analysis``,
against the JAX package, on the CPU.

Configs compare exactly (``dataclasses.asdict``, ``to_dict``, the YAML
text, and each bad config's exception class name and message).
``cost_analysis``: the port counts every tap of each convolution (2 a
multiply-add, the zero padding's taps included), XLA only the taps inside
the image plus the elementwise operations. The test recounts the port's
model without the padding's taps and holds XLA's count to it: above it,
by under 2% (the elementwise operations of a UNet of width 4 at 64²).
"""

import dataclasses
import importlib
import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from rfi_toolbox_tpu.config import ConfigLoader as JaxConfigLoader
from rfi_toolbox_tpu.config import TrainingConfig as JaxTrainingConfig
from rfi_toolbox_tpu.config import loader as jax_loader
from rfi_toolbox_tpu.config import validators as jax_validators
from rfi_toolbox_tpu.utils.profiling import StepTimer as JaxStepTimer
from rfi_toolbox_tpu_torch.config import ConfigLoader, TrainingConfig
from rfi_toolbox_tpu_torch.config import loader as port_loader
from rfi_toolbox_tpu_torch.config import validators as port_validators
from rfi_toolbox_tpu_torch.utils import StepTimer, annotate, trace

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").rglob("*.yaml"))


def _outcome(fn, *args):
    """``("ok", value)`` or ``("raised", class name, message)``."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the comparison is the point
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_every_config_loads_alike(path):
    assert CONFIGS, "no configs found"
    jt, pt = JaxConfigLoader.load_training(path), ConfigLoader.load_training(path)
    assert dataclasses.asdict(pt) == dataclasses.asdict(jt)
    assert dataclasses.asdict(ConfigLoader.load(path)) == dataclasses.asdict(jt)
    jd, pd = JaxConfigLoader.load_data(path), ConfigLoader.load_data(path)
    assert pd.to_dict() == jd.to_dict()
    assert sorted(vars(pd)) == sorted(vars(jd))
    if path.name == "unet_default.yaml":  # the shipped configs say device: tpu
        assert pt.device == "tpu" and pt.in_channels == 8 and pt.batch_size == 32


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_save_in_one_load_in_the_other(tmp_path, direction):
    """A file saved by one package loads alike in both (``norm`` is neither
    saved nor read from YAML in either: it comes back as the default), and
    both packages write the same text."""
    kwargs = {"batch_size": 8, "learning_rate": 3e-4, "mesh_shape": (2, 1),
              "num_antennas": 5, "stretch": None, "norm": "group",
              "compute_dtype": "float32", "seed": 7}
    path = tmp_path / "cfg.yaml"
    if direction == "jax->port":
        JaxConfigLoader.save(JaxTrainingConfig(**kwargs), path)
        ConfigLoader.save(TrainingConfig(**kwargs), tmp_path / "other.yaml")
    else:
        ConfigLoader.save(TrainingConfig(**kwargs), path)
        JaxConfigLoader.save(JaxTrainingConfig(**kwargs), tmp_path / "other.yaml")
    assert path.read_text() == (tmp_path / "other.yaml").read_text()
    got = dataclasses.asdict(ConfigLoader.load_training(path))
    assert got == dataclasses.asdict(JaxConfigLoader.load_training(path))
    assert got == {**dataclasses.asdict(JaxTrainingConfig(**kwargs)), "norm": "batch"}


def test_create_default_config_writes_the_same_text(tmp_path):
    JaxConfigLoader.create_default_config(tmp_path / "jax.yaml")
    ConfigLoader.create_default_config(tmp_path / "port.yaml")
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()


BAD_CONFIGS = {
    "device": {"training": {"device": "gpu"}},
    "compute_dtype": {"training": {"compute_dtype": "float16"}},
    "checkpoint": {"model": {"checkpoint": "huge"}},
    "stretch": {"dataset": {"stretch": "SQRT2"}},
    "processing_stretch": {"processing": {"stretch": "LN"}},
    "batch_size": {"training": {"batch_size": 0}},
    "learning_rate": {"training": {"learning_rate": -1.0}},
    "num_epochs": {"training": {"num_epochs": -3}},
    "patch_size": {"dataset": {"patch_size": 0}},
    "mesh_not_a_list": {"training": {"mesh_shape": 5}},
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS) + ["empty", "missing", "not_yaml"])
def test_bad_configs_fail_alike(tmp_path, name):
    path = tmp_path / f"{name}.yaml"
    if name == "empty":
        path.write_text("# nothing\n")
    elif name == "not_yaml":
        path.write_text("model: [unclosed\n  training: {")
    elif name != "missing":
        path.write_text(yaml.dump(BAD_CONFIGS[name]))
    jax_out = _outcome(JaxConfigLoader.load_training, path)
    port_out = _outcome(ConfigLoader.load_training, path)
    assert jax_out[0] == "raised", jax_out
    assert port_out == jax_out
    if name in ("empty", "missing", "not_yaml"):
        assert _outcome(ConfigLoader.load_data, path) == _outcome(
            JaxConfigLoader.load_data, path)


def test_invalid_norm_field_fails_alike():
    jax_out = _outcome(lambda: JaxTrainingConfig(norm="layer"))
    assert jax_out[0] == "raised"
    assert _outcome(lambda: TrainingConfig(norm="layer")) == jax_out


@pytest.mark.parametrize("case", [
    ("validate_preprocessing_config", {"patch_size": 100}),
    ("validate_preprocessing_config", {"stretch": "LN"}),
    ("validate_preprocessing_config", {"augmentation_rotations": 3}),
    ("validate_preprocessing_config", {"patch_size": 256, "stretch": "SQRT"}),
    ("validate_training_config", {"sam_checkpoint": "xl"}),
    ("validate_training_config", {"batch_size": 0}),
    ("validate_training_config", {"batch_size": 129}),
    ("validate_training_config", {"learning_rate": 2.0}),
    ("validate_training_config", {"learning_rate": 0.0}),
    ("validate_training_config", {"batch_size": 16, "learning_rate": 1e-3}),
    ("validate_paths_exist", {"dataset": "/nonexistent/rfi"}),
    ("validate_paths_exist", {"ms_path": "/nonexistent/x.ms"}),
    ("validate_paths_exist", {"model_path": "/nonexistent/m.npz"}),
    ("validate_paths_exist", {"dataset": "."}),
], ids=lambda c: f"{c[0]}-{'-'.join(map(str, c[1].items()))}")
def test_validators_agree(case):
    name, config = case
    jax_out = _outcome(getattr(jax_validators, name), config)
    assert _outcome(getattr(port_validators, name), config) == jax_out
    if jax_out[0] == "raised":
        assert jax_out[1] == "ConfigValidationError"


@pytest.mark.parametrize("data", [
    {"processing": {"patch_size": 512}, "training": {"batch_size": 300}},
    {"processing": {"patch_size": 64}},
    {"training": {"learning_rate": 1e-3}, "processing": {"stretch": None}},
])
def test_validate_all_agrees(data):
    jax_out = _outcome(jax_validators.validate_all, jax_loader.DataConfig(data))
    assert _outcome(port_validators.validate_all, port_loader.DataConfig(data)) == jax_out


# -- profiling ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip_first", [0, 1, 3])
def test_step_timer_summary_matches_jax(skip_first):
    times = [0.5, 0.012, 0.011, 0.013, 0.0105, 0.02]
    items = [64, 64, 64, 32, 64, 64]
    port, ref = StepTimer(skip_first=skip_first), JaxStepTimer(skip_first=skip_first)
    for t in (port, ref):
        t.times.extend(times)
        t.items.extend(items)
    assert port.summary() == ref.summary()
    port.reset()
    ref.reset()
    assert port.summary() == ref.summary() == {"steps": 0}


def test_step_timer_times_a_step():
    timer = StepTimer(sync=True, skip_first=0)
    with timer.step(items=4, result=torch.zeros(1)):
        time.sleep(0.01)
    s = timer.summary()
    assert s["steps"] == 1 and s["mean_ms"] >= 10 and s["items_per_sec"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "prof"):
        with annotate("rfi-stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "rfi-stage" for e in events)


# -- the reference-path aliases ----------------------------------------------------------


@pytest.mark.parametrize("name", ["core", "preprocessing", "datasets", "data_generation",
                                  "scripts", "cli", "config", "visualization", "utils"])
def test_alias_exports_match_jax(name):
    jax_mod = importlib.import_module(f"rfi_toolbox_tpu.{name}")
    port_mod = importlib.import_module(f"rfi_toolbox_tpu_torch.{name}")
    jax_names = set(jax_mod.__all__)
    if name == "utils":  # platform.py and transfer.py pin JAX's runtime: not ported
        jax_names -= {"configure_platform", "enable_compilation_cache", "to_device", "to_host"}
        assert set(port_mod.__all__) == jax_names | {"resolve_device", "set_tf32"}
    else:
        assert set(port_mod.__all__) == jax_names
    for attr in port_mod.__all__:
        obj = (importlib.import_module(f"rfi_toolbox_tpu_torch.cli.{attr}") if name == "cli"
               else getattr(port_mod, attr))
        where = getattr(obj, "__module__", None) or obj.__name__  # a module has no __module__
        assert where.startswith("rfi_toolbox_tpu_torch."), (attr, where)


# -- CompiledPredictor.cost_analysis -----------------------------------------------------


def _unpadded_conv_flops(model, batch, hw):
    """2 a multiply-add of the convolution taps inside the image (XLA's
    count of a 'same' 3x3 conv leaves out the taps on its zero padding)."""
    total = 0

    def hook(mod, inp, out):
        nonlocal total
        n, ci, h, w = inp[0].shape
        if isinstance(mod, nn.ConvTranspose2d):
            total += 2 * n * ci * mod.out_channels * out.shape[2] * out.shape[3]
        elif mod.kernel_size == (3, 3):
            total += 2 * n * ci * mod.out_channels * (3 * h - 2) * (3 * w - 2)
        else:
            total += 2 * n * ci * mod.out_channels * h * w

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    with torch.no_grad():
        model(torch.zeros(batch, 3, hw, hw))
    for h in handles:
        h.remove()
    return total


@pytest.mark.parametrize("tta", [False, True])
def test_cost_analysis_against_xla(tta):
    from rfi_toolbox_tpu.models import UNet as FlaxUNet
    from rfi_toolbox_tpu.serving import CompiledPredictor as JaxPredictor
    from rfi_toolbox_tpu_torch.models import UNet, params_from_flax
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor

    f, hw, batch = 4, 64, 2
    flax_model = FlaxUNet(init_features=f)
    v = flax_model.init(jax.random.key(0), np.zeros((1, hw, hw, 3), np.float32), train=False)
    ref = JaxPredictor(flax_model, v["params"], v["batch_stats"], input_shape=(hw, hw, 3),
                       batch_size=batch, tta=tta).cost_analysis
    ref = ref[0] if isinstance(ref, list) else ref
    model = UNet(init_features=f)
    model.load_state_dict(params_from_flax(v["params"], v["batch_stats"], model))
    pred = CompiledPredictor(model, input_shape=(hw, hw, 3), batch_size=batch, tta=tta,
                             device="cpu")
    got = pred.cost_analysis
    assert set(got) == {"flops"}
    forwards = 4 if tta else 1
    unpadded = forwards * _unpadded_conv_flops(pred.model, batch, hw)
    assert unpadded < ref["flops"] < 1.02 * unpadded
    assert got["flops"] > ref["flops"]  # the padding's taps outweigh the elementwise ops
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        pred.model(torch.zeros(batch, 3, hw, hw))
    assert got["flops"] == forwards * counter.get_total_flops()
