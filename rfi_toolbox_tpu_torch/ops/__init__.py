"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper runs its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor; the kernels are built by
:mod:`._lib` on first launch.

- K4 ``fused_extract_channels`` (csrc/fused_channels.cu)
- K5 ``mad_flag_patches`` (csrc/mad_flags.cu)
"""

from .fused_channels import fused_extract_channels, fused_extract_channels_plain
from .mad_flags import mad_flag_patches, mad_flag_patches_plain

__all__ = [
    "fused_extract_channels",
    "fused_extract_channels_plain",
    "mad_flag_patches",
    "mad_flag_patches_plain",
]
