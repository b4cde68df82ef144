"""SyntheticDataGenerator: config-driven dataset generation to disk, on
the card.

Counterpart of ``rfi_toolbox_tpu/synth/generator.py``, with its on-disk
contract: batch files through ``BatchWriter`` into ``output/exact_masks``
(and ``output/mad_masks`` with ``generate_mad_masks``), their
``metadata.json`` (with ``format``), ``generation_metadata.json`` and
``rfi_parameters.json``; ``save_raw`` mode, and the ``Preprocessor``
pass otherwise. Either package's trainer reads what the other wrote.

Each generation batch is drawn on the device in one call of the port's
sampler (:func:`.sample.make_sample_generator`) from one
``torch.Generator`` seeded with ``seed``; its stream is not
``jax.random``'s, so the tests compare files by structure and by the
values that do not depend on random draws. The whole batch is then
preprocessed on the device (``Preprocessor.create_dataset``: K4 for the
extraction, at any patch size), and the MAD masks of the whole
waterfalls are K5's (``ops.mad_flag_patches``). ``generation_workers``
in configs is accepted and ignored, as in the JAX package.
"""

import json
from pathlib import Path

import torch

from .. import ops
from ..data.batched_dataset import ArrayDataset, BatchWriter
from ..preprocess import pipeline as P
from ..preprocess.preprocessor import Preprocessor
from ..utils.device import resolve_device
from ..utils.progress import progress
from .sample import make_sample_generator, params_to_event_list

__all__ = ["SyntheticDataGenerator", "RawPatchDataset"]


class RawPatchDataset(ArrayDataset):
    """Raw patches (no preprocessing), ``BatchWriter``-compatible through
    ``.images`` and ``.labels``."""


def _cfg_get(cfg, key, default=None):
    """Config access for a dict, an object with ``get`` or attributes."""
    if cfg is None:
        return default
    if hasattr(cfg, "get"):
        try:
            return cfg.get(key, default)
        except TypeError:
            pass
    if isinstance(cfg, dict):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


class SyntheticDataGenerator:
    """Generate segmentation training datasets from synthetic RFI.

    Args:
        config: configuration with ``synthetic`` and ``processing``
            sections (``configs/data_generation/*.yaml``, as a dict or an
            object; the JAX package's schema).
        seed: integer seed of the device generator (default 0).
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.
    """

    def __init__(self, config, seed=0, device=None):
        self.config = config
        self.seed = seed
        self.device = device

    # -- config parsing ---------------------------------------------------
    def _parse_rfi_config(self, config):
        """``rfi_type_counts`` merged with the ``rfi_types`` enable-list:
        event type -> ``{"count": int | [min, max]}``."""
        rfi_types = _cfg_get(
            config, "rfi_types",
            ["narrowband_persistent", "broadband_persistent", "frequency_sweep"])
        default_counts = _cfg_get(config, "rfi_type_counts", {}) or {}
        get = (default_counts.get if isinstance(default_counts, dict)
               else lambda k, d: _cfg_get(default_counts, k, d))
        rfi_config = {
            "narrowband_persistent": {"count": get("narrowband_persistent", 1)},
            "broadband_persistent": {"count": get("broadband_persistent", 1)},
            "narrowband_intermittent": {"count": get("narrowband_intermittent", 0)},
            "narrowband_bursty": {"count": get("narrowband_bursty", 1)},
            "broadband_bursty": {"count": get("broadband_bursty", 0)},
            "frequency_sweep": {"count": get("frequency_sweep", 1)},
        }
        if rfi_types:
            known = (default_counts if isinstance(default_counts, dict)
                     else getattr(default_counts, "__dict__", {}))
            for rfi_type in rfi_config:
                if rfi_type not in rfi_types and rfi_type not in known:
                    rfi_config[rfi_type]["count"] = 0
        return rfi_config

    def _build_batch_generator(self):
        """The batched sampler of the config's ``synthetic`` section, and
        its event config."""
        synth = _cfg_get(self.config, "synthetic")
        rfi_config = self._parse_rfi_config(synth)
        sample_fn = make_sample_generator(
            num_channels=_cfg_get(synth, "num_channels", 2048),
            num_times=_cfg_get(synth, "num_times", 512),
            noise_level=_cfg_get(synth, "noise_mjy", 1.0),
            rfi_power_min=_cfg_get(synth, "rfi_power_min", 1000.0),
            rfi_power_max=_cfg_get(synth, "rfi_power_max", 10000.0),
            rfi_config=rfi_config,
            enable_bandpass=_cfg_get(synth, "enable_bandpass_rolloff", False),
            bandpass_order=_cfg_get(synth, "bandpass_polynomial_order", 8),
            num_polarizations=_cfg_get(synth, "num_polarizations", 1),
            pol_corr=_cfg_get(synth, "polarization_correlation", 0.8),
            device=self.device,
        )
        return sample_fn, rfi_config

    def generate_batch(self, generator, batch_size):
        """One batch on the device: ``(waterfalls (B, P, C, T) complex64,
        masks (B, P, C, T) bool, params)``, drawn from ``generator`` (a
        ``torch.Generator`` on the device)."""
        sample_fn, _ = self._build_batch_generator()
        return sample_fn(batch_size, generator)

    # -- on-disk generation ----------------------------------------------
    def generate(self, output_path):
        """Generate the configured dataset under ``output_path``: the
        ``exact_masks/`` (and optional ``mad_masks/``) batch files,
        ``generation_metadata.json`` and ``rfi_parameters.json``. Returns
        the output directory as a str."""
        synth = _cfg_get(self.config, "synthetic")
        proc = _cfg_get(self.config, "processing")

        num_samples = _cfg_get(synth, "num_samples", 100)
        num_channels = _cfg_get(synth, "num_channels", 2048)
        num_times = _cfg_get(synth, "num_times", 512)
        noise_level = _cfg_get(synth, "noise_mjy", 1.0)
        rfi_power_min = _cfg_get(synth, "rfi_power_min", 1000.0)
        rfi_power_max = _cfg_get(synth, "rfi_power_max", 10000.0)
        batch_size = _cfg_get(synth, "generation_batch_size", 50)
        generate_mad = _cfg_get(synth, "generate_mad_masks", False)
        enable_bandpass = _cfg_get(synth, "enable_bandpass_rolloff", False)
        pol_corr = _cfg_get(synth, "polarization_correlation", 0.8)

        save_raw = _cfg_get(proc, "save_raw", False)
        patch_size = _cfg_get(proc, "patch_size", 128)
        enable_aug = _cfg_get(proc, "enable_augmentation", True)
        rotations = _cfg_get(proc, "augmentation_rotations", 4)
        effective_rotations = rotations if enable_aug else 1
        flag_sigma = _cfg_get(proc, "flag_sigma", 5)

        sample_fn, rfi_config = self._build_batch_generator()
        generator = torch.Generator(device=resolve_device(self.device))
        generator.manual_seed(int(self.seed))

        output_dir = Path(output_path)
        output_dir.mkdir(parents=True, exist_ok=True)
        exact_writer = BatchWriter(output_dir / "exact_masks", samples_per_batch=100)
        mad_writer = (BatchWriter(output_dir / "mad_masks", samples_per_batch=100)
                      if generate_mad else None)

        all_rfi_parameters = []
        total_raw = 0
        total_patches = 0
        num_batches = (num_samples + batch_size - 1) // batch_size
        for batch_idx in progress(range(num_batches), desc="Generate", total=num_batches):
            n = min(batch_size, num_samples - total_raw)
            waterfalls, masks, params = sample_fn(n, generator)
            all_rfi_parameters.extend(params_to_event_list(params))

            if save_raw:
                # the magnitude averaged over pols, the masks max-combined
                dataset = RawPatchDataset(P.magnitude(waterfalls).mean(dim=1),
                                          masks.any(dim=1).to(torch.uint8))
            else:
                pre = Preprocessor(waterfalls, flags=masks, device=self.device)
                dataset = pre.create_dataset(
                    patch_size=patch_size,
                    stretch=_cfg_get(proc, "stretch", None),
                    flag_sigma=flag_sigma,
                    use_custom_flags=True,
                    num_patches=_cfg_get(proc, "num_patches", None),
                    normalize_before_stretch=_cfg_get(proc, "normalize_before_stretch", True),
                    normalize_after_stretch=_cfg_get(proc, "normalize_after_stretch", False),
                    enable_augmentation=enable_aug,
                    augmentation_rotations=rotations,
                    seed=self.seed + batch_idx + 1,
                )
            exact_writer.add_batch(dataset)
            if mad_writer is not None:
                mag = P.magnitude(waterfalls).reshape(-1, num_channels, num_times)
                mad_flags = ops.mad_flag_patches(mag.contiguous(), float(flag_sigma))
                mad_writer.add_batch(ArrayDataset(mag, mad_flags.to(torch.uint8)))
            total_patches += len(dataset)
            total_raw += n

        batch_meta = exact_writer.finalize()
        batch_meta["format"] = "raw" if save_raw else "preprocessed"
        with open(output_dir / "exact_masks" / "metadata.json", "w") as f:
            json.dump(batch_meta, f, indent=2)
        if mad_writer is not None:
            mad_writer.finalize()

        metadata = {
            "source": "synthetic",
            "physical_parameters": {
                "noise_mjy": noise_level,
                "rfi_power_min_jy": rfi_power_min,
                "rfi_power_max_jy": rfi_power_max,
            },
            "num_raw_samples": total_raw,
            "num_channels": num_channels,
            "num_times": num_times,
            "rfi_config": {
                k: v for k, v in rfi_config.items()
                if (v["count"][1] if isinstance(v["count"], (list, tuple)) else v["count"]) > 0
            },
            "bandpass": {
                "enabled": bool(enable_bandpass),
                "polynomial_order": (_cfg_get(synth, "bandpass_polynomial_order", 8)
                                     if enable_bandpass else None),
            },
            "polarization_correlation": pol_corr,
            "augmentation": {"enabled": bool(enable_aug), "rotations": effective_rotations},
            "num_patches": total_patches,
            "patch_size": patch_size,
            "stretch": _cfg_get(proc, "stretch", None),
            "ground_truth": "exact",
            "seed": self.seed,
            "batch_processing": {
                "generation_batch_size": batch_size,
                "num_batches": num_batches,
            },
        }
        with open(output_dir / "generation_metadata.json", "w") as f:
            json.dump(metadata, f, indent=2)
        with open(output_dir / "rfi_parameters.json", "w") as f:
            json.dump(all_rfi_parameters, f, indent=2)
        return str(output_dir)
