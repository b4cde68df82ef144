"""Port parity: the synthetic dataset generator (``SyntheticDataGenerator``,
``params_to_event_list``, ``_parse_rfi_config``) against the JAX
package, on the CPU, and the configurations that ``chip_smoke.py``
generates on the card against the YAML files they cut.

The random streams differ (``torch.Generator`` here, ``jax.random``
there), so ``generate()`` is compared with JAX's by its files: the same
file set, the same metadata (which depends on no draw at these settings:
every whole waterfall holds RFI), event lists of the same structure, and
arrays of the same shapes and types. The arrays the port writes are held
to the JAX package's functions on the port's own draws: its batches drawn
again from the seed and taken through JAX's ``Preprocessor`` and MAD
flags give the same labels, bit for bit, and the same images within 2e-5
(magnitudes within a float32 rounding). Exact: ``params_to_event_list``
on one params dict given to both, and the parsed event config.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rfi_toolbox_tpu.preprocess import Preprocessor as JaxPreprocessor
from rfi_toolbox_tpu.preprocess import pipeline as JP
from rfi_toolbox_tpu.synth import SyntheticDataGenerator as JaxGenerator
from rfi_toolbox_tpu.synth.sample import make_sample_generator as jax_sample_generator
from rfi_toolbox_tpu.synth.sample import params_to_event_list as jax_event_list
from rfi_toolbox_tpu_torch.synth import (
    RawPatchDataset,
    SyntheticDataGenerator,
    params_to_event_list,
)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5  # the JAX package's own extraction bound (ops/fused_channels.py)
COUNTS = {"narrowband_persistent": 3, "broadband_persistent": 2, "frequency_sweep": 1,
          "narrowband_bursty": 2, "broadband_bursty": 1}


def _config(save_raw=False):
    return {
        "synthetic": {"num_samples": 3, "num_channels": 64, "num_times": 64,
                      "noise_mjy": 1.0, "rfi_power_min": 1000.0, "rfi_power_max": 10000.0,
                      "rfi_type_counts": dict(COUNTS), "enable_bandpass_rolloff": True,
                      "bandpass_polynomial_order": 8, "polarization_correlation": 0.8,
                      "num_polarizations": 2, "generation_batch_size": 2,
                      "generate_mad_masks": True},
        "processing": {"normalize_before_stretch": False, "normalize_after_stretch": False,
                       "stretch": None, "flag_sigma": 5, "patch_size": 64,
                       "enable_augmentation": True, "augmentation_rotations": 4,
                       "save_raw": save_raw},
    }


def test_params_to_event_list_matches_jax():
    rc = {"narrowband_persistent": {"count": 2}, "broadband_persistent": {"count": 1},
          "narrowband_intermittent": {"count": [0, 2]}, "frequency_sweep": {"count": [0, 2]},
          "narrowband_bursty": {"count": 2}, "broadband_bursty": {"count": 1}}
    fn = jax.vmap(jax_sample_generator(32, 32, rfi_config=rc))
    _, _, params = fn(jax.random.split(jax.random.key(0), 4))
    params = jax.tree.map(np.asarray, params)
    want = jax_event_list(params)
    assert params_to_event_list(params) == want
    assert len(want) == 4 and all(len(s) >= 6 for s in want)
    one = jax.tree.map(lambda a: a[1], params)
    assert params_to_event_list(one) == jax_event_list(one) == want[1]
    assert json.dumps(params_to_event_list(params)) == json.dumps(want)


@pytest.mark.parametrize("synth", [
    {},
    {"rfi_type_counts": dict(COUNTS)},
    {"rfi_types": ["narrowband_persistent", "narrowband_bursty"]},
    {"rfi_types": ["frequency_sweep"], "rfi_type_counts": {"broadband_bursty": [1, 3]}},
])
def test_parse_rfi_config_matches_jax(synth):
    assert (SyntheticDataGenerator({})._parse_rfi_config(synth)
            == JaxGenerator({})._parse_rfi_config(synth))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _json(root, name):
    return json.loads((root / name).read_text())


@pytest.mark.parametrize("save_raw", [False, True], ids=["preprocessed", "raw"])
def test_generate_writes_the_jax_files(tmp_path, save_raw):
    cfg = _config(save_raw)
    port = Path(SyntheticDataGenerator(cfg, seed=3, device="cpu").generate(tmp_path / "port"))
    jax_ = Path(JaxGenerator(cfg, seed=3).generate(str(tmp_path / "jax")))
    assert _files(port) == _files(jax_) == [
        "exact_masks/batch_000.npz", "exact_masks/metadata.json", "generation_metadata.json",
        "mad_masks/batch_000.npz", "mad_masks/metadata.json", "rfi_parameters.json"]
    for name in ("exact_masks/metadata.json", "mad_masks/metadata.json",
                 "generation_metadata.json"):
        assert _json(port, name) == _json(jax_, name), name
    n = 3 * (2 if save_raw else 2 * 4)  # samples x pols (averaged when raw) x rotations
    assert _json(port, "generation_metadata.json")["num_patches"] == (3 if save_raw else n)

    got, want = _json(port, "rfi_parameters.json"), _json(jax_, "rfi_parameters.json")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):  # fixed counts: the same events, field for field
        assert [(e["type"], sorted(e)) for e in g] == [(e["type"], sorted(e)) for e in w]
        for e in g:
            assert 1e6 <= e["amplitude_mjy"] <= 1e7
            assert all(isinstance(v, (int, float)) for v in e.values() if v != e["type"])

    want = _jax_files_of_port_draws(cfg, seed=3)
    for sub in ("exact_masks", "mad_masks"):
        with np.load(port / sub / "batch_000.npz") as a, np.load(jax_ / sub / "batch_000.npz") as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (sub, k)
            images, labels = a["images"], a["labels"]
            want_images, want_labels = want[sub]
            # the labels bit-equal; the images within 2e-5 after the
            # ImageNet affine, within a float32 rounding as magnitudes
            np.testing.assert_array_equal(labels, want_labels, err_msg=sub)
            if sub == "exact_masks" and not save_raw:
                np.testing.assert_allclose(images, want_images, rtol=0, atol=TOL, err_msg=sub)
            else:
                np.testing.assert_allclose(images, want_images, rtol=1e-6, atol=0, err_msg=sub)
            if sub == "mad_masks":  # JAX's MAD flags of the file's own magnitudes
                np.testing.assert_array_equal(
                    labels, np.asarray(JP.mad_flag_patches(jnp.asarray(images), 5.0)))
            assert 0 < labels.mean() < 0.95  # neither all nor none flagged


def _jax_files_of_port_draws(cfg, seed):
    """The arrays that the JAX package's preprocessing and MAD flags
    write for the port's own draws: the port's generation batches drawn
    again from ``seed`` (``generate_batch``, as ``generate`` draws them),
    each taken through JAX's ``Preprocessor.create_dataset`` (or the raw
    average) with the config's arguments and through JAX's
    ``mad_flag_patches``. Returns ``{subdir: (images, labels)}``."""
    synth, proc = cfg["synthetic"], cfg["processing"]
    port = SyntheticDataGenerator(cfg, seed=seed, device="cpu")
    generator = torch.Generator().manual_seed(seed)
    out = {"exact_masks": ([], []), "mad_masks": ([], [])}
    done = 0
    for batch_idx in range(-(-synth["num_samples"] // synth["generation_batch_size"])):
        n = min(synth["generation_batch_size"], synth["num_samples"] - done)
        waterfalls, masks, _ = port.generate_batch(generator, n)
        waterfalls, masks = waterfalls.numpy(), masks.numpy()
        if proc["save_raw"]:
            images = np.asarray(jnp.abs(waterfalls).mean(axis=1).astype(jnp.float32))
            labels = masks.max(axis=1).astype(np.uint8)
        else:
            ds = JaxPreprocessor(waterfalls, flags=masks).create_dataset(
                patch_size=proc["patch_size"], stretch=proc["stretch"],
                flag_sigma=proc["flag_sigma"], use_custom_flags=True, num_patches=None,
                normalize_before_stretch=proc["normalize_before_stretch"],
                normalize_after_stretch=proc["normalize_after_stretch"],
                enable_augmentation=proc["enable_augmentation"],
                augmentation_rotations=proc["augmentation_rotations"],
                seed=seed + batch_idx + 1)
            images, labels = np.asarray(ds.images), np.asarray(ds.labels)
        mag = jnp.abs(waterfalls).reshape(-1, synth["num_channels"], synth["num_times"])
        flags = np.asarray(JP.mad_flag_patches(mag, float(proc["flag_sigma"])))
        for sub, pair in (("exact_masks", (images, labels)),
                          ("mad_masks", (np.asarray(mag), flags.astype(np.uint8)))):
            out[sub][0].append(pair[0])
            out[sub][1].append(pair[1])
        done += n
    return {sub: tuple(np.concatenate(a) for a in pair) for sub, pair in out.items()}


def test_raw_patch_dataset_is_an_array_dataset():
    ds = RawPatchDataset(np.zeros((2, 4, 4), np.float32), np.zeros((2, 4, 4), np.uint8))
    assert len(ds) == 2 and ds.metadata == {}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name, attr", [
    ("synthetic_train_4k.yaml", "TRAIN_4K_CONFIG"),
    ("synthetic_val_1k.yaml", "VAL_1K_CONFIG"),
])
def test_chip_smoke_configs_are_the_yaml_files_cut(name, attr):
    """Phase 14 of chip_smoke.py generates from the published data
    configs: the dict literal equals the YAML file, and the config it
    runs is that literal with the listed cuts (fewer samples; MAD masks
    on for training), every width unchanged."""
    cs = _chip_smoke()
    published = yaml.safe_load((ROOT / "configs" / "data_generation" / name).read_text())
    assert getattr(cs, "_" + attr.removesuffix("_CONFIG")) == published
    cut = cs.PHASE14_CUTS[attr]
    expected = {section: {**values, **cut.get(section, {})}
                for section, values in published.items()}
    assert getattr(cs, attr) == expected
    synth = getattr(cs, attr)["synthetic"]
    assert (synth["num_channels"], synth["num_times"]) == (1024, 1024)
    assert synth["num_polarizations"] == 2 and synth["bandpass_polynomial_order"] == 8
    assert set(cut) == {"synthetic"} and set(cut["synthetic"]) <= {"num_samples",
                                                                    "generate_mad_masks"}
