"""Segmentation models (PyTorch)."""

from .convert import load_params, params_from_flax, unet_from_snapshot
from .folding import fold_batchnorm
from .unet import (
    ConvTranspose2x2,
    Decoder,
    DoubleConv,
    Encoder,
    UNet,
    depth_to_space,
    space_to_depth,
)

__all__ = [
    "UNet",
    "DoubleConv",
    "Encoder",
    "ConvTranspose2x2",
    "Decoder",
    "space_to_depth",
    "depth_to_space",
    "fold_batchnorm",
    "load_params",
    "params_from_flax",
    "unet_from_snapshot",
]
