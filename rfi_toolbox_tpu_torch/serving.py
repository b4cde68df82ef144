"""Serving: a fixed-batch segmentation predictor.

Counterpart of ``rfi_toolbox_tpu/serving.py:CompiledPredictor``. The JAX
version compiles one executable for one static batch shape; here the
forward runs eagerly under ``torch.inference_mode()`` in float32 (TF32
off), and every request is still cut into chunks of exactly
``batch_size`` images, the last one zero-padded, so each forward sees the
same shape.

>>> from rfi_toolbox_tpu_torch.serving import CompiledPredictor
>>> pred = CompiledPredictor.from_snapshot("pretrained/unet16_synthetic.npz")
>>> masks = pred(images)        # (N, 128, 128, 3) -> (N, 128, 128) bool
"""

import torch

from .models.convert import unet_from_snapshot
from .models.folding import fold_batchnorm
from .utils.device import resolve_device, set_tf32

__all__ = ["CompiledPredictor"]


class CompiledPredictor:
    """Segmentation forward with a fixed batch size.

    Args:
        model: the port's UNet (``rfi_toolbox_tpu_torch.models.UNet``) with
            its weights loaded.
        input_shape: (H, W, C) of one image.
        batch_size: every forward runs on exactly this many images;
            requests of any length are chunked and zero-padded to it.
        threshold: sigmoid cut for the binary mask.
        tta: average the probabilities of the four flips (identity,
            flip H, flip W, both) before the cut; 4x the work.
        fold_norm: fold eval-mode BatchNorm into the convs
            (``models.fold_batchnorm``); skipped for models without
            BatchNorm. Logits then match the unfolded model to float
            rounding.
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.
    """

    def __init__(self, model, input_shape=(128, 128, 3), batch_size=32,
                 threshold=0.5, tta=False, fold_norm=True, device=None):
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.input_shape = tuple(input_shape)
        self.threshold = float(threshold)
        self.tta = bool(tta)
        self.folded = False
        if fold_norm and model.norm == "batch":
            model = fold_batchnorm(model)
            self.folded = True
        if self.device.type == "cuda":
            set_tf32(False)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_snapshot(cls, path, device=None, **kwargs):
        """Build from an ``export_params`` ``.npz`` snapshot. The UNet's
        architecture, the input channels and the threshold
        (``best_threshold``) default from the snapshot's metadata."""
        model, meta = unet_from_snapshot(path)
        kwargs.setdefault("input_shape", (128, 128, model.in_channels))
        if "best_threshold" in meta:
            kwargs.setdefault("threshold", float(meta["best_threshold"]))
        return cls(model, device=device, **kwargs)

    def logits(self, images):
        """(B, H, W, C) float32 tensor on the predictor's device ->
        (B, H, W) logits."""
        with torch.inference_mode():
            return self.model(images.permute(0, 3, 1, 2))[:, 0]

    def _mask(self, images):
        if not self.tta:
            return torch.sigmoid(self.logits(images)) > self.threshold
        b = images.shape[0]
        variants = torch.cat([images, images.flip(1), images.flip(2),
                              images.flip(1, 2)])
        p = torch.sigmoid(self.logits(variants))
        mean = (p[:b] + p[b:2 * b].flip(1) + p[2 * b:3 * b].flip(2)
                + p[3 * b:].flip(1, 2)) / 4
        return mean > self.threshold

    def __call__(self, images):
        """(N, H, W, C) tensor or array -> (N, H, W) bool tensor on the
        predictor's device, for any N."""
        x = torch.as_tensor(images).to(self.device, torch.float32)
        if tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(
                f"expected (N, {', '.join(map(str, self.input_shape))}), "
                f"got {tuple(x.shape)}"
            )
        n = x.shape[0]
        bs = self.batch_size
        out = torch.empty((n, *self.input_shape[:2]), dtype=torch.bool,
                          device=self.device)
        for start in range(0, n, bs):
            chunk = x[start:start + bs]
            valid = chunk.shape[0]
            if valid < bs:
                chunk = torch.cat([chunk, chunk.new_zeros((bs - valid,
                                                           *self.input_shape))])
            out[start:start + valid] = self._mask(chunk)[:valid]
        return out
