"""CLI ``generate_rfi_dataset``: synthetic .npy dataset or MS extraction.

Counterpart of ``rfi_toolbox_tpu/cli/generate_dataset.py`` (the
reference's scripts/generate_dataset.py:46-207): the synthetic path runs
the coherent-phase ``RFISimulator`` and writes one ``NNNN/`` directory
per sample with ``input.npy`` (8, T, F) float32, 4 pols x (real, imag),
and ``rfi_mask.npy``; ``--use_ms`` extracts train/val fields through
``RFIMaskDataset``.

Samples are made on the card in batches of ``--batch_size`` by
``RFISimulator.generate_rfi_device``, drawn from the simulator's own
``torch.Generator``, seeded from ``--seed``; each batch is copied to the
host once. The validation split continues the training split's stream.
(JAX's command starts both splits from ``random.key(0)``, whatever
``--seed``, so that its validation samples repeat its first training
samples.) ``--only_clean`` draws the host ``generate_clean_data`` from the
same generator.

    python -m rfi_toolbox_tpu_torch.cli.generate_dataset \\
        --samples_training 1000 --samples_validation 200 --output_dir rfi_dataset

The card is used unless ``--device cpu`` is given; without a card the
command raises.
"""

import argparse
import logging
import os

import numpy as np

from ..data import RFIMaskDataset
from ..synth.simulator import POLS, RFISimulator
from ..utils.device import resolve_device

__all__ = ["main", "save_example_pair_npy"]


def save_example_pair_npy(tf_plane, mask, index, out_dir, generate_mask=True):
    """Write input.npy (8, T, F) + rfi_mask.npy for one sample
    (generate_dataset.py:11-43)."""
    sample_dir = os.path.join(out_dir, f"{index:04d}")
    os.makedirs(sample_dir, exist_ok=True)
    input_data = np.stack(
        [
            tf_plane["RR"].real, tf_plane["RR"].imag,
            tf_plane["RL"].real, tf_plane["RL"].imag,
            tf_plane["LR"].real, tf_plane["LR"].imag,
            tf_plane["LL"].real, tf_plane["LL"].imag,
        ],
        axis=0,
    ).astype(np.float32)
    np.save(os.path.join(sample_dir, "input.npy"), input_data)
    if generate_mask:
        np.save(os.path.join(sample_dir, "rfi_mask.npy"), mask)


def _generate_split(simulator, n, out_dir, generate_mask, clean, batch=4):
    """Write ``n`` samples: batches of ``batch`` from
    ``simulator.generate_rfi_device`` on its device (one host copy a
    batch), or clean planes one at a time; both drawn from the
    simulator's own generator."""
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    while written < n:
        b = min(batch, n - written)
        if clean:
            for k in range(b):
                tf_plane, mask = simulator.generate_clean_data()
                save_example_pair_npy(
                    tf_plane, mask, written + k, out_dir, generate_mask
                )
        else:
            tf, masks = simulator.generate_rfi_device(b)
            tf, masks = tf.cpu().numpy(), masks.cpu().numpy()
            for k in range(b):
                tf_plane = {pol: tf[k, i] for i, pol in enumerate(POLS)}
                save_example_pair_npy(
                    tf_plane, masks[k], written + k, out_dir, generate_mask
                )
        written += b
        logging.info("  %d/%d samples written to %s", written, n, out_dir)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate or load RFI dataset as numpy files."
    )
    parser.add_argument("--samples_training", type=int, default=1000)
    parser.add_argument("--samples_validation", type=int, default=200)
    parser.add_argument("--output_dir", type=str, default="rfi_dataset")
    parser.add_argument("--only_clean", action="store_true",
                        help="Generate only clean data without RFI.")
    parser.add_argument("--time_bins", type=int, default=1024)
    parser.add_argument("--frequency_bins", type=int, default=1024)
    parser.add_argument("--generate_mask", action="store_true", default=True)
    parser.add_argument("--no_generate_mask", action="store_false",
                        dest="generate_mask")
    parser.add_argument("--use_ms", action="store_true", default=False)
    parser.add_argument("--ms_name", type=str, default=None)
    parser.add_argument("--train_field", type=int, default=None)
    parser.add_argument("--val_field", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=4,
                        help="Samples per device generation batch.")
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' runs on the CPU; default the CUDA card "
                        "(raises without one)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s"
    )

    device = resolve_device(args.device)

    if args.use_ms:
        if not args.ms_name:
            logging.error("Error: --ms_name must be specified when --use_ms is used.")
            return
        if args.only_clean:
            logging.error("Error: --only_clean is incompatible with --use_ms.")
            return
        ms_output_dir = os.path.join(args.output_dir, "ms_data")
        os.makedirs(ms_output_dir, exist_ok=True)
        train_dataset = RFIMaskDataset(
            data_dir=ms_output_dir, use_ms=True, ms_name=args.ms_name,
            field_selection=args.train_field, device=device,
        )
        val_dataset = RFIMaskDataset(
            data_dir=ms_output_dir, use_ms=True, ms_name=args.ms_name,
            field_selection=args.val_field, device=device,
        )
        logging.info("Training samples from MS: %d", len(train_dataset))
        logging.info("Validation samples from MS: %d", len(val_dataset))
        return

    simulator = RFISimulator(
        time_bins=args.time_bins, freq_bins=args.frequency_bins, seed=args.seed,
        device=device,
    )
    train_dir = os.path.join(args.output_dir, "train")
    if args.only_clean:
        logging.info("Generating only clean data without RFI.")
        _generate_split(simulator, args.samples_training, train_dir,
                        args.generate_mask, clean=True, batch=args.batch_size)
    else:
        _generate_split(simulator, args.samples_training, train_dir,
                        args.generate_mask, clean=False, batch=args.batch_size)
        val_dir = os.path.join(args.output_dir, "val")
        _generate_split(simulator, args.samples_validation, val_dir,
                        args.generate_mask, clean=False, batch=args.batch_size)
    logging.info("Dataset generation complete.")


if __name__ == "__main__":
    main()
