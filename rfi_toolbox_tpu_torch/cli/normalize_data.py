"""CLI ``normalize_rfi_data``: offline dataset normalization.

A copy of ``rfi_toolbox_tpu/cli/normalize_data.py`` (numpy on the host,
no device): standardize == whole-array z-score, robust_scale ==
median/IQR, global_min_max, as the reference's
scripts/normalize_rfi_data.py:8-74 computes them with sklearn's scalers
on a flattened array.

    python -m rfi_toolbox_tpu_torch.cli.normalize_data \
        --input_dir rfi_dataset/val --output_dir rfi_dataset/val_norm \
        --normalization robust_scale
"""

import argparse
import os
import shutil

import numpy as np

__all__ = ["main", "normalize_array", "process_directory"]


def normalize_array(data, method="standardize"):
    """Normalize one array with the chosen scheme."""
    if method == "standardize":
        mean = np.mean(data)
        std = np.std(data)
        return (data - mean) / (std if std > 0 else 1.0)
    if method == "robust_scale":
        median = np.median(data)
        q25, q75 = np.percentile(data, [25, 75])
        iqr = q75 - q25
        return (data - median) / (iqr if iqr > 0 else 1.0)
    if method == "global_min_max":
        lo, hi = np.min(data), np.max(data)
        if hi > lo:
            return (data - lo) / (hi - lo)
        return np.zeros_like(data)
    if method is None or method == "None":
        return data
    raise ValueError(f"Unsupported normalization method: {method}")


def process_directory(input_dir, output_dir, normalization_method):
    """Normalize every input.npy under input_dir into output_dir,
    copying rfi_mask.npy files verbatim."""
    os.makedirs(output_dir, exist_ok=True)
    total_files = processed = mask_files = 0
    for root, _, files in os.walk(input_dir):
        for filename in files:
            input_path = os.path.join(root, filename)
            rel = os.path.relpath(root, input_dir)
            out_sub = os.path.join(output_dir, rel)
            os.makedirs(out_sub, exist_ok=True)
            output_path = os.path.join(out_sub, filename)
            if filename == "input.npy":
                total_files += 1
                try:
                    data = np.load(input_path)
                    np.save(output_path, normalize_array(data, normalization_method))
                    processed += 1
                except Exception as e:  # keep going like the reference
                    print(f"Error processing {input_path}: {e}")
            elif filename == "rfi_mask.npy":
                mask_files += 1
                shutil.copy(input_path, output_path)
    print(
        f"Processed {processed}/{total_files} input files in '{input_dir}' "
        f"with normalization: {normalization_method}"
    )
    print(f"Copied {mask_files} mask files to '{output_dir}'.")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Normalize RFI dataset numpy files."
    )
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument(
        "--normalization", type=str, default="standardize",
        choices=["global_min_max", "standardize", "robust_scale", "none",
                 "None"],
    )
    args = parser.parse_args(argv)
    method = None if args.normalization in ("none", "None") else args.normalization
    process_directory(args.input_dir, args.output_dir, method)
    print("Normalization complete.")


if __name__ == "__main__":
    main()
