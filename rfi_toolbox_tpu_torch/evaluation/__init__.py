"""Segmentation metrics, and the instance metrics of SOLOLite."""

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

__all__ = [
    "confusion_counts",
    "compute_iou",
    "compute_precision",
    "compute_recall",
    "compute_f1",
    "compute_dice",
    "evaluate_segmentation",
    "evaluate_segmentation_batch",
    "match_instances",
    "evaluate_instance_model",
]
