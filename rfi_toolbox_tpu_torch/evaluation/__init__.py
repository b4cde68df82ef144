"""Segmentation metrics."""

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

__all__ = [
    "confusion_counts",
    "compute_iou",
    "compute_precision",
    "compute_recall",
    "compute_f1",
    "compute_dice",
    "evaluate_segmentation",
    "evaluate_segmentation_batch",
]
