"""Segmentation metrics for RFI flags.

Counterpart of ``rfi_toolbox_tpu/evaluation/metrics.py``: one confusion
count reduction serves IoU, precision, recall, F1 and Dice, computed in
float32 with the reference's edge cases:

- IoU: union == 0 -> 1.0
- precision: no predictions -> 1.0 if no true RFI else 0.0
- recall: no true RFI -> 1.0
- F1: P + R == 0 -> 0.0
- Dice: 2TP + FP + FN == 0 -> 1.0

Inputs may be tensors (on any device) or numpy arrays; any dtype is cast
to bool.
"""

import torch

__all__ = [
    "confusion_counts",
    "compute_iou",
    "compute_precision",
    "compute_recall",
    "compute_f1",
    "compute_dice",
    "evaluate_segmentation",
]


def confusion_counts(pred, true):
    """(TP, FP, FN, TN) as float32 scalars, over all elements."""
    pred = torch.as_tensor(pred).bool()
    true = torch.as_tensor(true, device=pred.device).bool()
    tp = (pred & true).sum()
    fp = (pred & ~true).sum()
    fn = (~pred & true).sum()
    tn = pred.numel() - tp - fp - fn
    return tuple(v.to(torch.float32) for v in (tp, fp, fn, tn))


def _iou(tp, fp, fn):
    union = tp + fp + fn
    return torch.where(union == 0, 1.0, tp / torch.clamp(union, min=1.0))


def _precision(tp, fp, fn):
    abstain = torch.where(fn == 0, 1.0, 0.0)
    return torch.where(tp + fp == 0, abstain, tp / torch.clamp(tp + fp, min=1.0))


def _recall(tp, fn):
    return torch.where(tp + fn == 0, 1.0, tp / torch.clamp(tp + fn, min=1.0))


def _f1(tp, fp, fn):
    p = _precision(tp, fp, fn)
    r = _recall(tp, fn)
    return torch.where(p + r == 0, 0.0, 2.0 * p * r / torch.clamp(p + r, min=1e-30))


def _dice(tp, fp, fn):
    denom = 2.0 * tp + fp + fn
    return torch.where(denom == 0, 1.0, 2.0 * tp / torch.clamp(denom, min=1.0))


def _all(tp, fp, fn):
    return {
        "iou": _iou(tp, fp, fn),
        "precision": _precision(tp, fp, fn),
        "recall": _recall(tp, fn),
        "f1": _f1(tp, fp, fn),
        "dice": _dice(tp, fp, fn),
    }


def compute_iou(pred, true):
    """Intersection over union; union == 0 -> 1.0."""
    tp, fp, fn, _ = confusion_counts(pred, true)
    return float(_iou(tp, fp, fn))


def compute_precision(pred, true):
    """TP / (TP + FP); no predictions -> 1.0 if no true RFI else 0.0."""
    tp, fp, fn, _ = confusion_counts(pred, true)
    return float(_precision(tp, fp, fn))


def compute_recall(pred, true):
    """TP / (TP + FN); no true RFI -> 1.0."""
    tp, _, fn, _ = confusion_counts(pred, true)
    return float(_recall(tp, fn))


def compute_f1(pred, true):
    """2PR / (P + R); P + R == 0 -> 0.0."""
    tp, fp, fn, _ = confusion_counts(pred, true)
    return float(_f1(tp, fp, fn))


def compute_dice(pred, true):
    """2TP / (2TP + FP + FN); empty/empty -> 1.0."""
    tp, fp, fn, _ = confusion_counts(pred, true)
    return float(_dice(tp, fp, fn))


def evaluate_segmentation(pred, true):
    """All five metrics as python floats: keys 'iou', 'precision',
    'recall', 'f1', 'dice'."""
    tp, fp, fn, _ = confusion_counts(pred, true)
    return {k: float(v) for k, v in _all(tp, fp, fn).items()}

