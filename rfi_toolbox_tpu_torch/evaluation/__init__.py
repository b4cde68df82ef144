"""Segmentation metrics, the instance metrics of SOLOLite, and the
flagging-quality statistics (MAD, FFI, calcquality)."""

from .instances import evaluate_instance_model, match_instances
from .metrics import (
    compute_dice,
    compute_f1,
    compute_iou,
    compute_precision,
    compute_recall,
    confusion_counts,
    evaluate_segmentation,
    evaluate_segmentation_batch,
)
from .statistics import (
    compute_calcquality,
    compute_ffi,
    compute_mad,
    compute_statistics,
    print_statistics_comparison,
)

__all__ = [
    "confusion_counts",
    "compute_iou",
    "compute_precision",
    "compute_recall",
    "compute_f1",
    "compute_dice",
    "evaluate_segmentation",
    "evaluate_segmentation_batch",
    "compute_mad",
    "compute_statistics",
    "compute_ffi",
    "compute_calcquality",
    "print_statistics_comparison",
    "match_instances",
    "evaluate_instance_model",
]
