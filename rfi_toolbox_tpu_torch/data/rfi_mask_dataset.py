"""RFIMaskDataset: sample-directory dataset for the 8-channel pipeline.

Counterpart of ``rfi_toolbox_tpu/data/rfi_mask_dataset.py``, as a
``torch.utils.data.Dataset``. Each sample directory holds ``input.npy``
(8, F, T), 4 pols x (real, imag), and ``rfi_mask.npy``. Two modes: scan a
directory of sample dirs, or extract samples from a Measurement Set
(``use_ms=True``) through :class:`~rfi_toolbox_tpu_torch.io.ms_loader.MSLoader`,
writing one ``ant{i}_ant{j}/`` directory per baseline with a zero
(chan, time) mask.

The normalisation parameters come from one streaming pass over the
files on the host, in float64 as JAX's numpy code computes them; each
item is normalised in float32 on the dataset's device, and its tensors
are bit-equal to JAX's numpy arrays.
"""

import os

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["RFIMaskDataset"]


class RFIMaskDataset(torch.utils.data.Dataset):
    """Dataset over sample directories of (input.npy, rfi_mask.npy).

    Args:
        data_dir: directory containing (or to contain) sample dirs.
        transform: optional callable (input, mask) -> (input, mask) on
            the tensors.
        normalization: 'global_min_max' | 'standardize' | 'robust_scale'
            | None.
        use_ms: extract samples from a measurement set first.
        ms_name: MS path or FakeMS (required when use_ms).
        field_selection: int or list of FIELD_IDs to include.
        device: where items are made: ``None`` for the CUDA card, or e.g.
            ``"cpu"``.

    Items are ``(input (8, F, T) float32, mask (1, F, T) float32)``
    tensors on the device.
    """

    def __init__(self, data_dir, transform=None, normalization="global_min_max",
                 use_ms=False, ms_name=None, field_selection=None, device=None):
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.transform = transform
        self.normalization = normalization
        self.use_ms = use_ms
        self.ms_name = ms_name
        self.field_selection = field_selection
        self.global_min = np.inf
        self.global_max = -np.inf
        self.mean = None
        self.std = None
        self.robust_median = None
        self.robust_iqr = None
        self.sample_dirs = []
        self.antenna_baseline_map = []

        if use_ms:
            if ms_name is None:
                raise ValueError("ms_name must be provided when use_ms is True")
            self.sample_dirs = self._generate_ms_samples()
        else:
            self.sample_dirs = sorted(
                os.path.join(data_dir, d)
                for d in os.listdir(data_dir)
                if os.path.isdir(os.path.join(data_dir, d))
            )

        self._calculate_normalization_params()

    # -- normalization ----------------------------------------------------
    def _calculate_normalization_params(self):
        """Streaming global min/max/mean/std; percentile-based robust
        params on a bounded sample of each file."""
        count = 0
        total = 0.0
        total_sq = 0.0
        robust_sample = []
        for sample_dir in self.sample_dirs:
            x = np.load(os.path.join(sample_dir, "input.npy"))
            self.global_min = min(self.global_min, float(np.min(x)))
            self.global_max = max(self.global_max, float(np.max(x)))
            total += float(np.sum(x, dtype=np.float64))
            total_sq += float(np.sum(np.square(x, dtype=np.float64)))
            count += x.size
            if self.normalization == "robust_scale":
                flat = x.ravel()
                step = max(1, flat.size // 4096)
                robust_sample.append(flat[::step])
        if count:
            self.mean = total / count
            self.std = float(np.sqrt(max(total_sq / count - self.mean**2, 0.0)))
            self.std += 1e-8
        if robust_sample:
            allv = np.concatenate(robust_sample)
            self.robust_median = float(np.median(allv))
            q25, q75 = np.percentile(allv, [25, 75])
            self.robust_iqr = float(q75 - q25) + 1e-8

    def _affine(self, x, shift, scale):
        """(x - shift) / scale in float32, the two python floats rounded
        to float32 first as numpy does with a float32 array; both as
        tensors on x's device, so that the card divides (a scalar divisor
        would be turned into a multiply by its reciprocal)."""
        shift = torch.tensor(np.float32(shift), device=x.device)
        scale = torch.tensor(np.float32(scale), device=x.device)
        return (x - shift) / scale

    def _normalize_input(self, x):
        if self.normalization == "global_min_max":
            if self.global_max > self.global_min:
                return self._affine(x, self.global_min, self.global_max - self.global_min)
            return torch.zeros_like(x)
        if self.normalization == "standardize":
            return self._affine(x, self.mean, self.std)
        if self.normalization == "robust_scale":
            return self._affine(x, self.robust_median, self.robust_iqr)
        return x

    # -- dataset protocol -------------------------------------------------
    def __len__(self):
        return len(self.sample_dirs)

    def __getitem__(self, idx):
        sample_dir = self.sample_dirs[idx]
        x = np.load(os.path.join(sample_dir, "input.npy")).astype(np.float32)
        mask = np.load(os.path.join(sample_dir, "rfi_mask.npy")).astype(np.float32)
        x = self._normalize_input(torch.from_numpy(x).to(self.device))
        mask = torch.from_numpy(mask[None]).to(self.device)  # (1, F, T)
        if self.transform:
            x, mask = self.transform(x, mask)
        return x, mask

    # -- MS extraction ----------------------------------------------------
    def _generate_ms_samples(self):
        """Walk the MS per baseline writing ant{i}_ant{j}/input.npy as
        8 channels (4 pols x re/im) and a zero (chan, time) mask (the
        reference wrote a transposed (time, chan) one)."""
        # imported here: io imports the flagging path, which imports data
        from ..io.ms_loader import MSLoader

        field_ids = [None]
        if self.field_selection is not None:
            field_ids = (
                [self.field_selection]
                if isinstance(self.field_selection, int)
                else list(self.field_selection)
            )

        sample_dirs = []
        for field in field_ids:
            # a loader per field: it counts the integrations of its own
            # field (JAX's one loader counts those of all fields, and its
            # load of one field of a multi-field MS raises)
            loader = MSLoader(self.ms_name, field_id=field)
            data = loader.load()
            for (i, j), baseline in zip(loader.antenna_baseline_map, data):
                sample_dir = os.path.join(self.data_dir, f"ant{i}_ant{j}")
                os.makedirs(sample_dir, exist_ok=True)
                self.antenna_baseline_map.append((i, j))
                input_data = np.stack(
                    [part for pol in baseline[:4] for part in (pol.real, pol.imag)],
                    axis=0,
                ).astype(np.float32)  # (8, chan, time)
                np.save(os.path.join(sample_dir, "input.npy"), input_data)
                mask = np.zeros(baseline.shape[1:], dtype=np.float32)
                np.save(os.path.join(sample_dir, "rfi_mask.npy"), mask)
                sample_dirs.append(sample_dir)
            loader.close()
        return sample_dirs
