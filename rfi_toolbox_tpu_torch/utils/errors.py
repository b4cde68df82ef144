"""Custom exceptions for rfi_toolbox_tpu_torch (a copy of
``rfi_toolbox_tpu/utils/errors.py``: the same hierarchy)."""


class RFIToolboxError(Exception):
    """Base exception for rfi_toolbox_tpu_torch."""


class ConfigValidationError(RFIToolboxError):
    """Raised when configuration validation fails.

    Caught early, before expensive operations like training or data
    generation.
    """


class DataShapeError(RFIToolboxError):
    """Raised when data has an unexpected shape.

    Example: loading MS data with incompatible dimensions, or a
    preprocessing pipeline that would produce wrong-sized patches.
    """
