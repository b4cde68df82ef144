"""Instance-segmentation quality of SOLOLite: COCO-style greedy matching.

Counterpart of ``rfi_toolbox_tpu/evaluation/instances.py``:
``match_instances`` is its numpy code, and ``evaluate_instance_model``
scores an :class:`~rfi_toolbox_tpu_torch.train.InstanceTrainer` on
held-out batches of its own generator. Batch ``j`` is drawn from a
``torch.Generator`` seeded ``seed + j`` (the port's stream, disjoint from
training's, which ``_stream_seed`` keys), and its images come from K4
(``ops.fused_extract_channels``) on the card, its plain version on the
CPU.
"""

import numpy as np
import torch

from .. import ops

__all__ = ["match_instances", "evaluate_instance_model"]


def _per_class(score_thresh):
    return np.ndim(score_thresh) > 0 or isinstance(score_thresh, (list, tuple))


def match_instances(detections, gt_masks, gt_classes, gt_valid=None, iou_thresh=0.5,
                    score_thresh=0.3, require_class=True):
    """Greedy score-ordered matching of one image's detections to its
    ground-truth instances.

    Args:
        detections: dict with ``masks`` (K, H, W) bool, ``scores`` (K,),
            ``classes`` (K,): one image's decode.
        gt_masks: (M, H, W) bool; gt_classes: (M,) int.
        gt_valid: (M,) bool (padded rows False); default: any pixel set.
        iou_thresh: the match threshold.
        score_thresh: detections below it are ignored; a scalar, or a
            sequence indexed by class id.
        require_class: a match must also agree on the class.

    Returns dict: ``matched`` (M,) bool, ``best_iou`` (M,) the best IoU
    of each GT over same-class detections (regardless of threshold),
    ``n_gt``, ``n_det``, ``tp``, ``recall``, ``precision``.
    """
    masks = np.asarray(detections["masks"], bool)
    scores = np.asarray(detections["scores"], float)
    classes = np.asarray(detections["classes"], int)
    gt_masks = np.asarray(gt_masks, bool)
    gt_classes = np.asarray(gt_classes, int)
    if gt_valid is None:
        gt_valid = gt_masks.any(axis=(1, 2))
    gt_valid = np.asarray(gt_valid, bool)

    thresh = (np.asarray(score_thresh, float)[classes] if _per_class(score_thresh)
              else float(score_thresh))
    keep = scores >= thresh
    order = np.argsort(-scores[keep])
    det_idx = np.nonzero(keep)[0][order]

    gt_idx = np.nonzero(gt_valid)[0]
    n_gt = len(gt_idx)
    matched = np.zeros(len(gt_masks), bool)
    best_iou = np.zeros(len(gt_masks), float)

    if n_gt and len(det_idx):
        gt_flat = gt_masks[gt_idx].reshape(n_gt, -1)
        gt_area = gt_flat.sum(axis=1)
        for d in det_idx:
            dm = masks[d].reshape(-1)
            inter = (gt_flat & dm).sum(axis=1)
            union = gt_area + dm.sum() - inter
            iou = inter / np.maximum(union, 1)
            if require_class:
                iou = np.where(gt_classes[gt_idx] == classes[d], iou, 0.0)
            best_iou[gt_idx] = np.maximum(best_iou[gt_idx], iou)
            # greedy: the best still-unmatched GT above the threshold
            cand = np.where(matched[gt_idx], -1.0, iou)
            j = int(np.argmax(cand))
            if cand[j] >= iou_thresh:
                matched[gt_idx[j]] = True

    tp = int(matched.sum())
    n_det = int(keep.sum())
    return {
        "matched": matched,
        "best_iou": best_iou,
        "n_gt": n_gt,
        "n_det": n_det,
        "tp": tp,
        "recall": tp / n_gt if n_gt else 1.0,
        "precision": tp / n_det if n_det else (1.0 if n_gt == 0 else 0.0),
    }


def evaluate_instance_model(trainer, num_images=32, seed=10_000, iou_thresh=0.5,
                            score_thresh=0.3, batch_size=None, mask_thresh=0.5,
                            nms_sigma=2.0):
    """Held-out quality of an ``InstanceTrainer`` on ``num_images`` images
    of its generator, in batches of ``batch_size`` (default the
    trainer's), batch ``j`` drawn from a generator seeded ``seed + j`` on
    the trainer's device.

    ``score_thresh`` may be a scalar or a per-class sequence (the decode
    then runs at its minimum, so that Matrix-NMS sees every candidate,
    and the per-class cut applies at matching).

    Returns dict: ``recall``, ``precision``, ``mean_best_iou``,
    ``per_class_recall``, ``n_gt``, ``n_det``, ``num_images``,
    ``iou_thresh``, ``score_thresh``, ``nms_sigma``, over all images.
    """
    batch_size = batch_size or trainer.batch_size
    per_class = _per_class(score_thresh)
    decode_thresh = float(np.min(score_thresh)) if per_class else float(score_thresh)
    tp = n_gt = n_det = 0
    best_ious = []
    per_class_tp, per_class_n = {}, {}

    done, j = 0, 0
    while done < num_images:
        g = torch.Generator(device=trainer.device).manual_seed(seed + j)
        batch = trainer._sample_fn(batch_size, g)
        take = min(batch_size, num_images - done)
        images = ops.fused_extract_channels(batch["waterfall"][:take].contiguous())
        dets = trainer.predict(images, score_thresh=decode_thresh, mask_thresh=mask_thresh,
                               nms_sigma=nms_sigma)
        gms, gcs, gvs = (batch[k][:take].cpu().numpy()
                         for k in ("inst_masks", "inst_classes", "inst_valid"))
        for i in range(take):
            r = match_instances(dets[i], gms[i], gcs[i], gvs[i], iou_thresh=iou_thresh,
                                score_thresh=score_thresh)
            tp += r["tp"]
            n_gt += r["n_gt"]
            n_det += r["n_det"]
            valid = gvs[i]
            best_ious.extend(r["best_iou"][valid].tolist())
            for c, m in zip(gcs[i][valid], r["matched"][valid]):
                per_class_n[int(c)] = per_class_n.get(int(c), 0) + 1
                per_class_tp[int(c)] = per_class_tp.get(int(c), 0) + int(m)
        done += take
        j += 1

    return {
        "recall": tp / n_gt if n_gt else 1.0,
        "precision": tp / n_det if n_det else 1.0,
        "mean_best_iou": float(np.mean(best_ious)) if best_ious else 0.0,
        "per_class_recall": {c: per_class_tp.get(c, 0) / n
                             for c, n in sorted(per_class_n.items())},
        "n_gt": n_gt,
        "n_det": n_det,
        "num_images": num_images,
        "iou_thresh": iou_thresh,
        "score_thresh": ([float(t) for t in np.asarray(score_thresh).ravel()]
                         if per_class else score_thresh),
        "nms_sigma": nms_sigma,
    }
