"""Where the port runs, and at what float32 precision.

Entry points take a ``device`` argument. ``None`` means the CUDA card;
the CPU is used only when the caller asks for it (``device="cpu"``), as
the tests do. Without a card, ``None`` raises instead of carrying on
quietly on the CPU.
"""

import torch

__all__ = ["resolve_device", "set_tf32"]


def resolve_device(device=None):
    """``None`` -> ``cuda``; anything else -> ``torch.device(device)``.

    Raises ``RuntimeError`` when a CUDA device is wanted (explicitly or by
    default) and this process has none.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def set_tf32(enabled):
    """Allow or forbid TF32 for float32 matmuls and cuDNN convolutions.

    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits); the port's parity path keeps both switches off so
    that the card computes in full float32 like the reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)
