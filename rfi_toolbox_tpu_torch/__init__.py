"""rfi_toolbox_tpu_torch - the PyTorch/CUDA port of rfi_toolbox_tpu.

The JAX package ``rfi_toolbox_tpu`` is the reference; this package
mirrors its layout module for module, so that each function's
counterpart is found under the same path. It imports ``torch`` and
``numpy`` only, never ``jax`` or any module of ``rfi_toolbox_tpu``.

Public layouts are the JAX package's: waterfalls ``(M, C, T)``, images
NHWC ``(N, H, W, 3)``, flags ``(M, C, T)`` bool. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; with no card
they raise instead of falling back.

Subpackages (the slice ported so far):
- utils: device resolution and the float32 precision switch
- preprocess: patchify/unpatchify, 3-channel extraction and MAD flags
  in plain PyTorch (the plain versions of the kernels)
- ops: hand-written CUDA kernels (csrc/) with their ctypes wrappers
- models: UNet, BatchNorm folding, Flax snapshot conversion
- serving: fixed-batch segmentation predictor
- io: ``flag_waterfalls``
- evaluation: segmentation metrics
"""

__version__ = "0.1.0"
