"""Segmentation models (PyTorch): the UNet and the SOLOLite instance model."""

from .convert import (
    load_params,
    params_from_flax,
    params_to_flax,
    save_params,
    sololite_from_flax,
    sololite_from_snapshot,
    sololite_to_flax,
    unet_from_snapshot,
)
from .instance import (
    SOLOLite,
    assign_targets,
    instance_masks_from_outputs,
    matrix_nms,
    solo_decode,
    solo_loss,
)
from .folding import fold_batchnorm
from .unet import (
    ConvTranspose2x2,
    Decoder,
    DoubleConv,
    Encoder,
    UNet,
    UNetBigger,
    UNetDifferentActivation,
    UNetOverfit,
    create_model,
    depth_to_space,
    space_to_depth,
)

__all__ = [
    "UNet",
    "UNetBigger",
    "UNetOverfit",
    "UNetDifferentActivation",
    "create_model",
    "DoubleConv",
    "Encoder",
    "ConvTranspose2x2",
    "Decoder",
    "space_to_depth",
    "depth_to_space",
    "fold_batchnorm",
    "load_params",
    "params_from_flax",
    "params_to_flax",
    "unet_from_snapshot",
    "save_params",
    "SOLOLite",
    "instance_masks_from_outputs",
    "assign_targets",
    "solo_loss",
    "matrix_nms",
    "solo_decode",
    "sololite_from_flax",
    "sololite_to_flax",
    "sololite_from_snapshot",
]
