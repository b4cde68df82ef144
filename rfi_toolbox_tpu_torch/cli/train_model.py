"""CLI ``train_rfi_model``: train a UNet on the 8-channel .npy pipeline,
or the coherent UNet (``--coherent``) or SOLOLite (``--instance``) on
samples generated on the card.

Counterpart of ``rfi_toolbox_tpu/cli/train_model.py`` (the reference's
scripts/train_model.py:82-197), with the same flags, defaults, precedence
and results:

- BCE+Dice loss, AdamW, grad clip 1.0, a NaN validation loss stops, best
  and final checkpoints; ``--checkpoint_path`` resumes (``--new_lr``
  overrides the rate) and ``--auto_resume`` takes the newest checkpoint;
- ``--config`` YAML values apply where no flag was given explicitly, and
  then count as explicit for the ``--coherent``/``--instance`` recipe
  defaults (``allow_abbrev=False``: the explicit-flag set matches raw
  argv tokens, so an abbreviation would defeat it);
- ``--augment`` adds a host-side flipped/transposed copy of the set.

Where the port differs: the model is built with the data's channel
count; checkpoints are the port's ``.pt`` files (``Trainer``'s, and the
coherent and instance trainers' ``step_{n}.pt``, which ``--auto_resume``
finds by their step); and every device is explicit (``--device``,
default the card, raising without one). ``--mesh_shape`` runs one
process a device: its product must be the job's world size (torchrun's,
or 1 in a plain process); any other shape is refused before anything is
built, never run on fewer devices than asked for. On the CPU the ranks
join by gloo (``--device cpu``), on the cards by NCCL.

    python -m rfi_toolbox_tpu_torch.cli.train_model \\
        --config configs/training/unet_default.yaml --batch_size 8
    python -m rfi_toolbox_tpu_torch.cli.train_model --instance --num_steps 1000
    torchrun --nproc_per_node 8 -m rfi_toolbox_tpu_torch.cli.train_model \\
        --config configs/training/unet_dp_tp.yaml     # (data 4, model 2)
"""

import argparse
import logging
import math
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import ConfigLoader
from ..data import ArrayDataset, RFIMaskDataset, StreamingDataset
from ..evaluation import evaluate_instance_model
from ..models import SOLOLite, create_model
from ..parallel import initialize_distributed, make_mesh
from ..parallel.mesh import world_size
from ..train import (
    CoherentTrainer,
    InstanceTrainer,
    Trainer,
    warmup_cosine_decay_schedule,
)
from ..utils.device import resolve_device

__all__ = ["main", "load_sample_dir_dataset"]


def load_sample_dir_dataset(data_dir, normalized_data_dir=None,
                            normalization=None, device=None):
    """Walk sample dirs for input.npy/rfi_mask.npy pairs into an
    ArrayDataset of host arrays, images NHWC (train_model.py:16-42); the
    items are made by ``RFIMaskDataset`` on ``device``."""
    base = normalized_data_dir if normalized_data_dir else data_dir
    ds = RFIMaskDataset(base, normalization=normalization, device=device)
    images, labels = [], []
    for i in range(len(ds)):
        x, m = ds[i]  # (C, F, T), (1, F, T)
        images.append(x.permute(1, 2, 0).cpu().numpy())  # NHWC
        labels.append(m[0].cpu().numpy().astype(np.uint8))
    return ArrayDataset(np.stack(images), np.stack(labels))


def _augment(images, labels, rng):
    """Random hflip/vflip/transpose per sample (in place of
    albumentations' HFlip/VFlip/Rotate, train_model.py:46-54)."""
    out_i, out_l = [], []
    for x, y in zip(images, labels):
        if rng.random() < 0.5:
            x, y = x[::-1], y[::-1]
        if rng.random() < 0.5:
            x, y = x[:, ::-1], y[:, ::-1]
        if x.shape[0] == x.shape[1] and rng.random() < 0.5:
            x, y = np.transpose(x, (1, 0, 2)), y.T
        out_i.append(np.ascontiguousarray(x))
        out_l.append(np.ascontiguousarray(y))
    return np.stack(out_i), np.stack(out_l)


def _mesh_shape(args):
    """``--mesh_shape`` as a tuple (None without one), checked before
    anything is built: ``--coherent`` parallelism is data-only, as in JAX,
    and the product must be the job's world size, since the port never
    runs on fewer devices than asked for."""
    if not args.mesh_shape:
        return None
    shape = tuple(int(x) for x in str(args.mesh_shape).split(","))
    if args.coherent and math.prod(shape[1:]) != 1:
        raise SystemExit(
            "--coherent parallelism is data-only; use "
            f"--mesh_shape {math.prod(shape)} (got {args.mesh_shape})"
        )
    world = world_size()
    if math.prod(shape) != world:
        raise SystemExit(
            f"--mesh_shape {args.mesh_shape} asks for {math.prod(shape)} devices but "
            f"this run has {world} process(es): start it as torchrun --nproc_per_node "
            f"{math.prod(shape)} ... (one process a device), or give a shape whose "
            f"product is {world}"
        )
    return shape


def _join(device):
    """Join torchrun's process group (a plain process makes one of its
    own in ``make_mesh``); a failed join raises."""
    if world_size() > 1 and not initialize_distributed(
            backend="gloo" if device.type == "cpu" else None):
        raise SystemExit("torchrun's process group did not start (see the warning above)")


def _latest_step_checkpoint(ckpt_dir):
    """The ``step_{n}.pt`` file with the largest n under ``ckpt_dir`` (the
    coherent and instance trainers' checkpoints), or None."""
    ckpts = [p for p in Path(ckpt_dir).glob("step_*.pt")
             if p.stem.split("_", 1)[1].isdigit()]
    return max(ckpts, key=lambda p: int(p.stem.split("_", 1)[1]), default=None)


def _train_coherent(args, given, device, shape):
    """``--coherent``: train an 8-channel UNet on coherent-simulator
    samples made on the card (the shipped-snapshot recipe,
    ``CoherentTrainer``), with checkpoint/resume, a closing held-out IoU
    threshold sweep and an optional .npz export."""
    mesh = None
    if shape:
        mesh = make_mesh((shape[0],), axis_names=("data",), device_type=device.type)
        logging.info("mesh: data=%d", shape[0])
    trainer = CoherentTrainer(
        init_features=(args.init_features if "init_features" in given
                       else 24),
        size=args.size,
        batch_size=args.batch_size if "batch_size" in given else 16,
        learning_rate=args.lr if "lr" in given else None,
        weight_decay=args.weight_decay,
        ema_decay=args.ema_decay,
        seed=args.seed,
        mesh=mesh,
        norm=args.norm,
        space_to_depth=args.space_to_depth,
        device=device,
    )

    ckpt_dir = Path(args.checkpoint_dir)
    ckpt = _latest_step_checkpoint(ckpt_dir) if args.auto_resume else None
    if ckpt is not None:
        trainer.restore_checkpoint(ckpt, num_steps_hint=args.num_steps)
        logging.info("resumed from %s at step %d", ckpt, trainer.step)

    remaining = args.num_steps - trainer.step
    if remaining > 0:
        trainer.fit(
            remaining,
            fused_steps=args.fused_steps,
            log_every=args.log_every,
            checkpoint_dir=ckpt_dir,
            checkpoint_every=args.checkpoint_every,
            callback=lambda step, loss: logging.info(
                "step %d - loss %.4f", step, loss),
        )
    else:
        logging.info("checkpoint already at step %d >= --num_steps %d; "
                     "skipping training", trainer.step, args.num_steps)

    report = trainer.evaluate(num_batches=args.eval_batches,
                              eval_batch=min(trainer.batch_size, 8))
    logging.info("held-out IoU sweep: best %.4f @ threshold %s",
                 report["best_iou"], report["best_threshold"])
    result = {"steps": trainer.step, "eval": report}
    if args.export:
        trainer.export(args.export,
                       best_threshold=report["best_threshold"])
        logging.info("snapshot exported to %s", args.export)
        result["export"] = args.export
    return result


def _load_event_config(path):
    import json

    text = open(path).read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text)


def _train_instance(args, given, device, shape):
    """``--instance``: train SOLOLite on synthetic event instances made on
    the card (the shipped-detector recipe, ``InstanceTrainer``), with
    checkpoint/resume, a closing held-out COCO-style quality eval and an
    optional .npz export."""
    features = args.init_features if "init_features" in given else 48
    model = SOLOLite(num_classes=args.num_classes,
                     grid_size=args.grid_size,
                     features=features, embed_dim=features,
                     space_to_depth=args.space_to_depth)
    if "lr" in given:
        lr = args.lr
    else:
        # the shipped recipe's schedule: a cold high-lr start collapses
        # the mask head on dense multi-event mixes (BASELINE.md)
        warmup = min(500, max(args.num_steps // 4, 1))
        lr = warmup_cosine_decay_schedule(
            1e-5, 8e-4, warmup, max(args.num_steps, warmup + 1),
            end_value=1e-5)
    trainer = InstanceTrainer(
        model=model,
        patch_size=args.patch_size,
        batch_size=args.batch_size if "batch_size" in given else 64,
        rfi_config=(_load_event_config(args.event_config)
                    if args.event_config else None),
        learning_rate=lr,
        weight_decay=args.weight_decay,
        seed=args.seed,
        mask_loss_stride=args.mask_loss_stride,
        max_positive_cells=args.max_positive_cells,
        mesh_shape=shape,
        device=device,
    )

    ckpt_dir = Path(args.checkpoint_dir)
    ckpt = _latest_step_checkpoint(ckpt_dir) if args.auto_resume else None
    if ckpt is not None:
        trainer.restore_checkpoint(ckpt)
        logging.info("resumed from %s at step %d", ckpt, trainer.step)

    history = []
    while trainer.step < args.num_steps:
        n = min(args.checkpoint_every, args.num_steps - trainer.step)
        res = trainer.fit(num_steps=n,
                          log_every=min(args.log_every, n),
                          fused_steps=args.fused_steps)
        history.extend(res["history"])
        trainer.save_checkpoint(ckpt_dir / f"step_{trainer.step}.pt")
        rec = res["history"][-1]
        logging.info("step %d - loss %.4f (cate %.4f, mask %.4f) "
                     "%.1f steps/s", trainer.step, rec["loss"],
                     rec["cate_loss"], rec["mask_loss"],
                     rec["steps_per_sec"])

    result = {"steps": trainer.step, "history": history}
    if args.eval_images > 0:
        q = evaluate_instance_model(
            trainer, num_images=args.eval_images, seed=10_000,
            iou_thresh=0.5, score_thresh=args.score_thresh)
        logging.info("held-out: recall %.3f precision %.3f "
                     "(%d images, IoU >= 0.5)", q["recall"],
                     q["precision"], args.eval_images)
        result["eval"] = q
    if args.export:
        trainer.save(args.export)
        logging.info("snapshot exported to %s", args.export)
        result["export"] = args.export
    return result


def main(argv=None):
    # allow_abbrev=False: the explicit-flag `given` set below matches
    # raw argv tokens against dest names, so a prefix abbreviation
    # (--batch for --batch_size) would silently defeat the recipe
    # defaults and YAML precedence
    parser = argparse.ArgumentParser(
        description="Train a UNet model for RFI masking",
        allow_abbrev=False,
    )
    parser.add_argument("--train_dir", type=str, default="rfi_dataset/train")
    parser.add_argument("--val_dir", type=str, default="rfi_dataset/val")
    parser.add_argument(
        "--train_batches_dir", type=str, default=None,
        help="Stream training data from a BatchWriter directory "
        "(e.g. <generate output>/exact_masks) with bounded host RAM "
        "instead of loading --train_dir sample dirs into memory")
    parser.add_argument("--val_batches_dir", type=str, default=None)
    parser.add_argument("--normalized_data_dir", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_epochs", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' runs on the CPU; default the CUDA card "
                        "(raises without one)")
    parser.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    parser.add_argument("--in_channels", type=int, default=8)
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="Resume training from this checkpoint")
    parser.add_argument("--new_lr", type=float, default=None,
                        help="Override learning rate when resuming")
    parser.add_argument("--weight_decay", type=float, default=1e-5)
    parser.add_argument(
        "--normalization", type=str, default=None,
        choices=["global_min_max", "standardize", "robust_scale", None],
    )
    parser.add_argument("--augment", action="store_true")
    parser.add_argument(
        "--model_type", type=str, default="unet",
        choices=["unet", "unet_bigger", "unet_overfit", "unet_activation"],
    )
    parser.add_argument("--init_features", type=int, default=32)
    parser.add_argument(
        "--norm", type=str, default="batch",
        choices=["batch", "group", "none"],
        help="UNet normalization: 'batch' = reference BatchNorm2d "
        "parity (default); 'group' = GroupNorm, no running stats "
        "(see BASELINE.md)")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--mesh_shape", type=str, default=None,
        help="'data,model' device mesh, e.g. '4,2' = 4-way data x 2-way "
        "tensor parallel (TrainingConfig.mesh_shape), one process a device: "
        "run under torchrun --nproc_per_node <product>; a product other than "
        "the run's process count is refused")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML training config (ConfigLoader schema); "
                        "CLI flags given explicitly still win")
    parser.add_argument("--auto_resume", action="store_true",
                        help="Resume from the newest checkpoint in "
                        "--checkpoint_dir if one exists")
    parser.add_argument(
        "--coherent", action="store_true",
        help="Train the coherent 8-channel pipeline with ON-CARD "
        "sample generation (CoherentTrainer — the recipe behind the "
        "shipped pretrained/unet*_coherent8ch.npz snapshots) instead "
        "of loading a dataset directory. Mode defaults change to the "
        "recipe's: init_features 24, batch_size 16, warmup-cosine "
        "learning rate (an explicit --lr overrides with a constant). "
        "norm='group' is recommended for long runs (BatchNorm "
        "running-stats calibration is unstable on this heavy-tailed "
        "task; see BASELINE.md)")
    parser.add_argument(
        "--space_to_depth", action="store_true",
        help="build the 2x2-packed model variant: with [--coherent] the "
        "UNet runs at half spatial resolution; with [--instance] the "
        "SOLOLite stem packs 2x2 into channels (full-res f-channel stage "
        "removed, mask head unchanged). Recorded in exported snapshot "
        "metadata so evaluate/serving reconstruct it")
    parser.add_argument(
        "--instance", action="store_true",
        help="Train a SOLOLite instance-segmentation detector on "
        "synthetic events made on the card (InstanceTrainer — the "
        "recipe behind pretrained/sololite_synthetic.npz) instead of "
        "loading a dataset directory. Mode defaults change to the "
        "recipe's: features 48 (--init_features), batch_size 64, "
        "warmup-cosine learning rate (explicit --lr overrides with a "
        "constant)")
    parser.add_argument("--num_steps", type=int, default=36_000,
                        help="[--coherent/--instance] total "
                        "optimization steps")
    parser.add_argument("--size", type=int, default=256,
                        help="[--coherent] square sample size")
    parser.add_argument("--ema_decay", type=float, default=0.999,
                        help="[--coherent] EMA decay for the exported "
                        "weights (0 disables)")
    parser.add_argument("--fused_steps", type=int, default=20,
                        help="[--coherent/--instance] generate+optimize "
                        "pairs run with no host sync between them")
    parser.add_argument("--checkpoint_every", type=int, default=4000,
                        help="[--coherent/--instance] steps between "
                        "step_{n}.pt checkpoints in --checkpoint_dir")
    parser.add_argument("--log_every", type=int, default=1000,
                        help="[--coherent/--instance] steps between "
                        "loss logs")
    parser.add_argument("--eval_batches", type=int, default=4,
                        help="[--coherent] held-out eval batches for "
                        "the closing IoU threshold sweep")
    parser.add_argument("--export", type=str, default=None,
                        help="[--coherent/--instance] write an "
                        "inference .npz snapshot here after training")
    parser.add_argument("--patch_size", type=int, default=128,
                        help="[--instance] square patch size")
    parser.add_argument("--grid_size", type=int, default=8,
                        help="[--instance] SOLO category grid")
    parser.add_argument("--num_classes", type=int, default=6,
                        help="[--instance] RFI event families")
    parser.add_argument("--mask_loss_stride", type=int, default=2,
                        help="[--instance] mask supervision stride "
                        "(2 = half-res, the shipped phase-1 recipe; "
                        "1 = full-res fine-tune)")
    parser.add_argument("--max_positive_cells", type=int, default=16,
                        help="[--instance] per-image positive-cell cap "
                        "in the mask loss; raise for dense event mixes "
                        "/ finer grids (the loss reports "
                        "dropped_mask_cells when it truncates)")
    parser.add_argument("--event_config", type=str, default=None,
                        help="[--instance] YAML/JSON rfi_config file "
                        "for the training event mix (same schema as "
                        "evaluate_rfi_model --event_config); default: "
                        "the reference's default 4-family mix")
    parser.add_argument("--eval_images", type=int, default=32,
                        help="[--instance] held-out images for the "
                        "closing quality eval (0 skips)")
    parser.add_argument("--score_thresh", type=float, default=0.3,
                        help="[--instance] score threshold for the "
                        "closing eval")
    args = parser.parse_args(argv)
    if args.coherent and args.instance:
        parser.error("--coherent and --instance are exclusive")

    # flags the user passed explicitly (vs argparse defaults) — used
    # for YAML-config precedence and the --coherent recipe defaults
    raw_args = argv if argv is not None else sys.argv[1:]
    given = {a.split("=")[0].lstrip("-").replace("-", "_")
             for a in raw_args if a.startswith("--")}

    if args.config:
        tc = ConfigLoader.load_training(args.config)
        defaults = {
            "batch_size": tc.batch_size,
            "num_epochs": tc.num_epochs,
            "lr": tc.learning_rate,
            "weight_decay": tc.weight_decay,
            "model_type": tc.model_type,
            "init_features": tc.init_features,
            "norm": tc.norm,
            "compute_dtype": tc.compute_dtype,
            "seed": tc.seed,
            "mesh_shape": (",".join(map(str, tc.mesh_shape))
                           if tc.mesh_shape else None),
        }
        # apply YAML values where the user didn't pass an explicit
        # flag; YAML-set values then count as explicit for the
        # --coherent/--instance recipe defaults
        for k, v in defaults.items():
            if k not in given:
                setattr(args, k, v)
                given.add(k)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    shape = _mesh_shape(args)
    device = resolve_device(args.device)
    if shape:
        _join(device)

    if args.coherent:
        return _train_coherent(args, given, device, shape)
    if args.instance:
        return _train_instance(args, given, device, shape)

    if args.train_batches_dir:
        train_ds = StreamingDataset(args.train_batches_dir)
        val_ds = (StreamingDataset(args.val_batches_dir)
                  if args.val_batches_dir else None)
        if val_ds is None:
            logging.warning(
                "no --val_batches_dir: training WITHOUT validation "
                "(no val loss, NaN early-stop, or best-checkpoint "
                "selection; --val_dir applies only to the sample-dir "
                "pipeline)"
            )
        logging.info(
            "streaming train=%d samples from %s (%d batch files)%s",
            len(train_ds), args.train_batches_dir, len(train_ds.files),
            f", val={len(val_ds)}" if val_ds else "",
        )
        if args.augment:
            logging.warning("--augment is ignored with --train_batches_dir")
        in_channels = train_ds.image_shape[-1]
    else:
        train_ds = load_sample_dir_dataset(
            args.train_dir, args.normalized_data_dir, args.normalization,
            device=device,
        )
        val_ds = load_sample_dir_dataset(
            args.val_dir, args.normalized_data_dir, args.normalization,
            device=device,
        )
        in_channels = train_ds.images.shape[-1]
        logging.info("train=%d samples, val=%d samples, image=%s",
                     len(train_ds), len(val_ds), train_ds.images.shape[1:])

    if args.augment and not args.train_batches_dir:
        rng = np.random.default_rng(args.seed)
        ai, al = _augment(train_ds.images, train_ds.labels, rng)
        train_ds = ArrayDataset(
            np.concatenate([train_ds.images, ai]),
            np.concatenate([train_ds.labels, al]),
        )

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = create_model(
        args.model_type, in_channels=in_channels,
        init_features=args.init_features, dtype=dtype,
        norm=args.norm, space_to_depth=args.space_to_depth,
    )
    lr = args.new_lr if (args.checkpoint_path and args.new_lr) else args.lr
    if shape:
        logging.info("mesh: data=%d x model=%d", *(shape + (1,))[:2])
    trainer = Trainer(
        model,
        learning_rate=lr,
        weight_decay=args.weight_decay,
        checkpoint_dir=args.checkpoint_dir,
        mesh_shape=shape,
        seed=args.seed,
        device=device,
    )
    resume = args.checkpoint_path or ("auto" if args.auto_resume else None)
    result = trainer.fit(
        train_ds,
        val_ds,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        resume_from=resume,
    )
    for rec in result["history"]:
        logging.info(
            "Epoch %d - train %.4f%s",
            rec["epoch"], rec["train_loss"],
            f" - val {rec['val_loss']:.4f} (iou {rec.get('val_iou', 0):.3f})"
            if "val_loss" in rec else "",
        )
    logging.info("Training finished. Best val loss: %.4f",
                 result["best_val_loss"])
    logging.info("Final model saved to %s", result["final_checkpoint"])
    return result


if __name__ == "__main__":
    main()
