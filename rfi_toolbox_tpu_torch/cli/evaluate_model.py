"""CLI ``evaluate_rfi_model``: evaluate a checkpoint on a dataset dir,
or a coherent (``--coherent``) or SOLOLite (``--instance``) snapshot on
held-out samples generated on the card.

Counterpart of ``rfi_toolbox_tpu/cli/evaluate_model.py`` (the reference's
scripts/evaluate_model.py:18-91), with the same flags, argument rules and
results. An ``.npz`` snapshot of either package is read with the port's
``load_params`` (``init_features``, ``norm``, ``space_to_depth`` and
``best_threshold`` from its metadata unless given); any other path is one
of the port's ``.pt`` checkpoints (``Trainer.restore``). The UNet is
built with the dataset's channel count. The card is used unless
``--device cpu`` is given; without a card the command raises.

    python -m rfi_toolbox_tpu_torch.cli.evaluate_model \
        --model_path pretrained/sololite_synthetic.npz --instance \
        --num_images 64 --score_thresh 0.25 \
        --event_config configs/evaluation/all_six_events.yaml
"""

import argparse

import numpy as np

from ..evaluation import evaluate_instance_model, evaluate_segmentation_batch
from ..models import create_model, load_params, params_from_flax
from ..train import CoherentTrainer, InstanceTrainer, Trainer, create_train_state
from ..utils.device import resolve_device
from .train_model import _load_event_config, load_sample_dir_dataset

__all__ = ["main", "evaluate_model", "evaluate_instance_snapshot"]


def evaluate_model(model_path, dataset_dir, batch_size=8, in_channels=8,
                   model_type="unet", init_features=None, threshold=None,
                   tta=False, norm=None, space_to_depth=None, device=None):
    """Average IoU/precision/recall/F1/Dice of a checkpoint over a
    sample-directory dataset. Returns the metric dict.

    For ``.npz`` snapshots, ``init_features`` and ``threshold`` default
    from the snapshot metadata when not given (``best_threshold`` is
    recorded by the pretrained training recipes); ``tta=True`` enables
    flip-averaged test-time augmentation (``Trainer.predict``). The model
    takes the dataset's channel count (``in_channels`` is accepted for the
    JAX signature, where it is unused too)."""
    del in_channels
    device = resolve_device(device)
    ds = load_sample_dir_dataset(dataset_dir, device=device)
    channels = ds.images.shape[-1]
    if str(model_path).endswith(".npz"):
        params, batch_stats, meta = load_params(model_path)
        if init_features is None:
            init_features = meta.get("init_features", 32)
        if threshold is None:
            threshold = meta.get("best_threshold", 0.5)
        if norm is None:
            norm = meta.get("norm", "batch")
        if space_to_depth is None:
            space_to_depth = bool(meta.get("space_to_depth", False))
        model = create_model(model_type, in_channels=channels,
                             init_features=init_features,
                             norm=norm, space_to_depth=space_to_depth)
        model.load_state_dict(params_from_flax(params, batch_stats, model))
        trainer = Trainer(model, device=device)
        trainer.state = create_train_state(model, seed=None, device=device)
    else:
        if init_features is None:
            init_features = 32
        model = create_model(model_type, in_channels=channels,
                             init_features=init_features,
                             norm=norm or "batch",
                             space_to_depth=bool(space_to_depth))
        trainer = Trainer(model, device=device)
        trainer.restore(model_path)
    if threshold is None:
        threshold = 0.5

    all_metrics = []
    for start in range(0, len(ds), batch_size):
        imgs = ds.images[start : start + batch_size]
        labels = ds.labels[start : start + batch_size]
        preds = trainer.predict(imgs, batch_size=batch_size,
                                threshold=threshold, tta=tta)
        m = evaluate_segmentation_batch(preds, labels > 0)
        all_metrics.append({k: v.cpu().numpy() for k, v in m.items()})
    return {
        k: float(np.mean(np.concatenate([m[k] for m in all_metrics])))
        for k in all_metrics[0]
    }


def evaluate_instance_snapshot(model_path, num_images=32, seed=10_000,
                               iou_thresh=0.5, score_thresh=0.3,
                               batch_size=8, event_config=None, device=None):
    """Held-out instance-segmentation quality of a SOLOLite snapshot
    (COCO-style per-event matching on fixed-seed synthetic batches made
    on ``device``; K4 once a batch on the card).

    ``event_config``: optional path to a YAML/JSON file mapping RFI
    event family -> parameter ranges (the ``rfi_config`` schema, e.g.
    ``{"broadband_bursty": {"count": [0, 1]}}``) — lets the CLI
    reproduce the all-six-family quality gate exactly."""
    kwargs = {}
    if event_config is not None:
        kwargs["rfi_config"] = _load_event_config(event_config)
    trainer = InstanceTrainer.load(model_path, batch_size=batch_size,
                                   device=device, **kwargs)
    return evaluate_instance_model(
        trainer, num_images=num_images, seed=seed,
        iou_thresh=iou_thresh, score_thresh=score_thresh,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate a trained RFI masking model."
    )
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' runs on the CPU; default the CUDA card "
                        "(raises without one)")
    parser.add_argument("--in_channels", type=int, default=8)
    parser.add_argument("--model_type", type=str, default="unet")
    parser.add_argument("--init_features", type=int, default=None,
                        help="Default: snapshot metadata init_features, "
                        "else 32")
    parser.add_argument("--norm", type=str, default=None,
                        choices=["batch", "group", "none"],
                        help="UNet normalization; default: snapshot "
                        "metadata norm, else 'batch'")
    parser.add_argument("--space_to_depth", action="store_true",
                        default=None,
                        help="Rebuild the 2x2-packed UNet variant for a "
                        ".pt checkpoint; .npz snapshots default from "
                        "metadata")
    parser.add_argument("--instance", action="store_true",
                        help="Evaluate a SOLOLite instance snapshot on "
                        "fixed-seed held-out synthetic batches instead "
                        "of a semantic dataset dir")
    parser.add_argument("--coherent", action="store_true",
                        help="Evaluate a coherent-8ch UNet snapshot on "
                        "the held-out simulator key stream (the "
                        "pretrained-gate convention: keys 10_000+, "
                        "disjoint from training) instead of a dataset "
                        "dir; prints the IoU threshold sweep")
    parser.add_argument("--num_images", type=int, default=32)
    parser.add_argument("--event_config", type=str, default=None,
                        help="YAML/JSON rfi_config file for --instance "
                        "held-out generation (e.g. the all-six-family "
                        "mix; default: the reference's default 4-family "
                        "event mix)")
    parser.add_argument("--iou_thresh", type=float, default=0.5)
    parser.add_argument("--score_thresh", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=10_000)
    parser.add_argument("--threshold", type=float, default=None,
                        help="Sigmoid threshold for semantic masks "
                        "(default: snapshot metadata best_threshold, "
                        "else 0.5)")
    parser.add_argument("--tta", action="store_true",
                        help="Flip-averaged test-time augmentation "
                        "(4x forward cost)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)

    if args.coherent:
        if args.instance:
            parser.error("--coherent and --instance are exclusive")
        if args.event_config is not None:
            parser.error("--event_config applies only to --instance")
        if (args.init_features is not None or args.norm is not None
                or args.space_to_depth is not None):
            parser.error("--init_features/--norm/--space_to_depth come "
                         "from the snapshot metadata with --coherent")
        trainer = CoherentTrainer.load(args.model_path, device=device)
        num_batches = max(1, args.num_images // args.batch_size)
        # an explicit --threshold restricts the sweep to that point;
        # default sweeps the standard 0.2-0.7 grid
        thresholds = ([args.threshold] if args.threshold is not None
                      else None)
        results = trainer.evaluate(num_batches=num_batches,
                                   eval_batch=args.batch_size,
                                   thresholds=thresholds,
                                   tta=args.tta)
        print("Coherent held-out IoU sweep "
              f"({num_batches * args.batch_size} samples"
              f"{', TTA' if args.tta else ''}):")
        for t, iou in results["ious"].items():
            print(f"  threshold {t}: {iou:.4f}")
        print(f"  best: {results['best_iou']:.4f} @ "
              f"{results['best_threshold']}")
        return results

    if args.instance:
        if args.tta or args.threshold is not None:
            parser.error("--threshold/--tta apply only to semantic "
                         "evaluation, not --instance")
        results = evaluate_instance_snapshot(
            args.model_path, num_images=args.num_images, seed=args.seed,
            iou_thresh=args.iou_thresh, score_thresh=args.score_thresh,
            batch_size=args.batch_size, event_config=args.event_config,
            device=device,
        )
        print("Instance Evaluation Results:")
        for metric, value in results.items():
            print(f"  {metric}: {value}")
        return results

    if not args.dataset_dir:
        parser.error("--dataset_dir is required unless --instance is set")
    results = evaluate_model(
        args.model_path, args.dataset_dir, args.batch_size,
        args.in_channels, args.model_type, args.init_features,
        threshold=args.threshold, tta=args.tta, norm=args.norm,
        space_to_depth=args.space_to_depth, device=device,
    )
    print("Evaluation Results:")
    for metric, value in results.items():
        print(f"  {metric}: {value:.4f}")
    return results


if __name__ == "__main__":
    main()
