"""Serving: a fixed-batch segmentation predictor.

Counterpart of ``rfi_toolbox_tpu/serving.py:CompiledPredictor``. The JAX
version compiles one executable for one static batch shape; here the
forward runs eagerly under ``torch.inference_mode()`` in float32 (TF32
off), and every request is still cut into chunks of exactly
``batch_size`` images, the last one zero-padded, so each forward sees the
same shape.

The forward's route (``CompiledPredictor.route``) follows from the model
after folding; both channels-last routes need a float32 UNet with ReLU,
no space-to-depth and no final sigmoid, and are built once at
construction and run in the ``predict.nhwc`` span inside
``predict.logits``:

- ``"k6a_nhwc"``, for ``norm="none"`` (a folded BatchNorm UNet, such as
  the shipped ``unet16_synthetic.npz``): :mod:`.models.nhwc_forward`, its
  3x3 convs on K6a with bias and ReLU fused;
- ``"k7_nhwc"``, for ``norm="group"`` (the GroupNorm snapshots:
  ``unet16gn_coherent8ch``, ``unet24gn_coherent8ch``,
  ``unet32gn_coherent8ch``, ``unet16gn_universal``):
  :mod:`.models.nhwc_groupnorm`, each DoubleConv one K7 call with both
  GroupNorms and ReLUs. It subclasses the first and overrides its block
  alone: GroupNorm's statistics span the image and cannot be folded into
  the convs, so the block differs; pool, up-convs and head are shared.

Every other model (another activation, space-to-depth, ``UNetOverfit``,
bfloat16, an unfolded BatchNorm) runs ``"eager"``: the model's own NCHW
forward.

>>> from rfi_toolbox_tpu_torch.serving import CompiledPredictor
>>> pred = CompiledPredictor.from_snapshot("pretrained/unet16_synthetic.npz")
>>> masks = pred(images)        # (N, 128, 128, 3) -> (N, 128, 128) bool
"""

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode

from .models.convert import unet_from_snapshot
from .models.folding import fold_batchnorm
from .models.nhwc_forward import NHWCForward
from .models.nhwc_groupnorm import GroupNormNHWCForward
from .utils.device import resolve_device, set_tf32
from .utils.profiling import span

__all__ = ["CompiledPredictor", "predict_mask"]

# the channels-last routes by name; their ``covers`` take disjoint models
_NHWC_ROUTES = {"k6a_nhwc": NHWCForward, "k7_nhwc": GroupNormNHWCForward}


def predict_mask(logits_fn, images, threshold, tta=False):
    """``sigmoid(logits_fn(images)) > threshold`` for (B, H, W, C) images.
    With ``tta`` the four flips (identity, flip H, flip W, both) run as
    one batch of 4B and their probabilities, flipped back, are averaged
    before the cut, as the JAX ``_predict_fwd_tta`` does."""
    if not tta:
        return torch.sigmoid(logits_fn(images)) > threshold
    b = images.shape[0]
    variants = torch.cat([images, images.flip(1), images.flip(2),
                          images.flip(1, 2)])
    p = torch.sigmoid(logits_fn(variants))
    mean = (p[:b] + p[b:2 * b].flip(1) + p[2 * b:3 * b].flip(2)
            + p[3 * b:].flip(1, 2)) / 4
    return mean > threshold


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

    ``route`` is ``"k6a_nhwc"`` where the model after folding is one
    :class:`~.models.nhwc_forward.NHWCForward` covers, ``"k7_nhwc"``
    where :class:`~.models.nhwc_groupnorm.GroupNormNHWCForward` covers it,
    else ``"eager"`` (module docstring).

    The predictor serves the model as it is at construction, on every
    route: treat ``model`` as read-only from then on. The channels-last
    routes forward copies of its weights taken at construction; to serve
    other weights, build a new predictor.
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
        self.route = next((name for name, forward in _NHWC_ROUTES.items()
                           if forward.covers(self.model)), "eager")
        self._nhwc = _NHWC_ROUTES[self.route](self.model) if self.route in _NHWC_ROUTES else None

    @classmethod
    def from_snapshot(cls, path, model=None, device=None, **kwargs):
        """Build from an ``export_params`` ``.npz`` snapshot. ``model``, the
        port's UNet to load the weights into (e.g. a ``UNetBigger``),
        defaults to the UNet the snapshot describes
        (``models.unet_from_snapshot``). The input channels and the threshold
        (``best_threshold``) default from the snapshot too."""
        model, meta = unet_from_snapshot(path, model)
        kwargs.setdefault("input_shape", (128, 128, model.in_channels))
        if "best_threshold" in meta:
            kwargs.setdefault("threshold", float(meta["best_threshold"]))
        return cls(model, device=device, **kwargs)

    @property
    def cost_analysis(self):
        """The operation count of one call's forward at the fixed batch
        and input shape (four forwards with ``tta``): ``{"flops": n}``,
        counted by ``torch.utils.flop_counter`` over a forward of a copy
        of the model on the meta device (no arithmetic runs). It counts 2
        a multiply-add of every convolution tap, those on the zero padding
        of each 3x3 conv included, and no elementwise operation. The JAX
        predictor's ``cost_analysis`` (XLA's) counts only the taps inside
        the image and adds the elementwise ones (bias, norm, ReLU,
        sigmoid); ``tests/test_torch_cli.py`` holds the two apart by
        exactly that."""
        model = copy.deepcopy(self.model).to("meta")
        x = torch.empty((self.batch_size, *self.input_shape), device="meta")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(x.permute(0, 3, 1, 2))
        return {"flops": float(counter.get_total_flops() * (4 if self.tta else 1))}

    def logits(self, images):
        """(B, H, W, C) float32 tensor on the predictor's device ->
        (B, H, W) logits: the model's forward alone, by :attr:`route`, in
        the ``predict.logits`` span."""
        with span("predict.logits"), torch.inference_mode():
            if self._nhwc is not None:
                return self._nhwc(images)
            return self.model(images.permute(0, 3, 1, 2))[:, 0]

    def _mask(self, images):
        return predict_mask(self.logits, images, self.threshold, self.tta)

    def __call__(self, images):
        """(N, H, W, C) tensor or array -> (N, H, W) bool tensor on the
        predictor's device, for any N; in the ``predict`` span."""
        with span("predict"):
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
