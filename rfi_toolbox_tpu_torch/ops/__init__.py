"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper runs its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor; the kernels are built by
:mod:`._lib` on first launch.

- K1 ``fused_gather_extract`` (csrc/channel_planes.cu; above 128 x 128
  csrc/extract_groups.cu, or where its slabs do not fit
  csrc/extract_strips.cu and csrc/plane_gather.cu)
- K2 ``fused_extract_channel_planes`` (csrc/channel_planes.cu; above
  128 x 128 csrc/extract_groups.cu or csrc/extract_strips.cu)
- K3 ``fused_plane_gather_transform`` and, into channels-last images,
  ``fused_plane_gather_transform_images`` (csrc/plane_gather.cu)
- K4 ``fused_extract_channels`` (csrc/channel_planes.cu; above 128 x 128
  csrc/extract_groups.cu or csrc/extract_strips.cu, by
  ``fused_channels.extract_route``)
- K5 ``mad_flag_patches`` (csrc/mad_flags.cu)
- K6a ``conv3x3_call`` (csrc/conv3x3.cu, csrc/conv3x3_mma.cuh), behind
  the differentiable ``conv3x3_bias_relu`` and ``conv3x3``, on the tensor
  cores in 3xTF32
- K6b ``conv3x3_dw`` (csrc/conv3x3.cu, csrc/mma_tf32.cuh), their weight
  gradient, on the tensor cores in 3xTF32 (float32 accuracy)
- K7 ``double_conv_gn_relu`` (csrc/double_conv_gn.cu, csrc/conv3x3_mma.cuh),
  on the tensor cores in 3xTF32
"""

from .conv3x3 import (
    conv3x3,
    conv3x3_bias_relu,
    conv3x3_call,
    conv3x3_call_plain,
    conv3x3_dw,
    conv3x3_dw_plain,
)

from .fused_channels import (
    fused_extract_channel_planes,
    fused_extract_channel_planes_plain,
    fused_extract_channels,
    fused_extract_channels_plain,
    fused_gather_extract,
    fused_gather_extract_plain,
    fused_plane_gather_transform,
    fused_plane_gather_transform_images,
    fused_plane_gather_transform_images_plain,
    fused_plane_gather_transform_plain,
)
from .fused_doubleconv import double_conv_gn_relu, double_conv_gn_relu_plain
from .mad_flags import mad_flag_patches, mad_flag_patches_plain

__all__ = [
    "fused_extract_channels",
    "fused_extract_channels_plain",
    "fused_extract_channel_planes",
    "fused_extract_channel_planes_plain",
    "fused_gather_extract",
    "fused_gather_extract_plain",
    "fused_plane_gather_transform",
    "fused_plane_gather_transform_plain",
    "fused_plane_gather_transform_images",
    "fused_plane_gather_transform_images_plain",
    "mad_flag_patches",
    "mad_flag_patches_plain",
    "conv3x3",
    "conv3x3_bias_relu",
    "conv3x3_call",
    "conv3x3_call_plain",
    "conv3x3_dw",
    "conv3x3_dw_plain",
    "double_conv_gn_relu",
    "double_conv_gn_relu_plain",
]
