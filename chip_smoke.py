#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port, on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout

It drives the port's flagging service (``rfi_toolbox_tpu_torch``) on the
card and fails (non-zero exit) if any phase fails:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: one nvcc call builds the CUDA kernels into build/torch_kernels/;
3. K4 (fused_extract_channels) against its plain PyTorch version on the
   card: 512 complex64 128x128 patches cut from 8 waterfalls of 1024 x
   1024, an odd N, a constant patch and real float32 input, max abs diff
   <= 2e-5; time per call (CUDA events, see ``cuda_ms``);
4. K5 (mad_flag_patches) at sigma 5 against its plain version, flags
   bit-equal: the 512 patches, whole 1024 x 1024 waterfalls, patches with
   NaNs, negative real input; time per call;
5. the model path, flag_waterfalls(method="model") with the shipped
   UNet16 snapshots (BatchNorm, GroupNorm) at full width on the 8 x 1024
   x 1024 waterfalls: IoU against the known RFI mask (> 0.9), K4
   launches, waterfalls/s; the card's logits against the same predictor on the CPU
   (TF32 off) on 8 patches;
6. the MAD path, flag_waterfalls(method="mad", sigma=5): IoU (> 0.5), K5
   launches, waterfalls/s.

Waterfalls/s is timed on the host clock over 3 windows of at least
``WINDOW_S`` seconds each (calls queued back to back, one synchronize at
the end of a window); the median and the spread of the windows are
printed.

The waterfalls are Gaussian noise with injected RFI stripes and blocks,
made with numpy from a fixed seed, so the exact mask is known. The
launch counts are set to 0 just before each path's run and read just
after it. The line before the last is one JSON object with each kernel's
launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX. Budget: under
3 minutes with the build.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260817
N_WATERFALLS, SIDE, PATCH = 8, 1024, 128
SIGMA = 5.0
K4_TOL = 2e-5
LOGIT_TOL = 2e-3  # f32 card vs f32 CPU: conv summation order differs
SNAPSHOTS = ("pretrained/unet16_synthetic.npz", "pretrained/unet16gn_universal.npz")
BATCH = 128  # the predictor's fixed batch
WINDOW_S = 1.0  # least host seconds of one timed window of flag_waterfalls
WINDOWS = 3
# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
K4_OPS_PER_PIXEL = 40  # |z|, log10, gradient, min/max, window, atan2, affine
# What K5's design spends, not what its function needs (an exact median
# and MAD take a few operations per pixel, so K5 is bound by its bytes):
# 2 radix selects x 32 passes x (2 compares + 2 adds) per pixel
K5_DESIGN_OPS_PER_PIXEL = 2 * 32 * 4

T_START = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T_START:6.1f}s] {msg}", flush=True)


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def make_waterfalls(rng):
    """8 complex64 waterfalls: |noise| ~ 1 +- 0.1, RFI of 1e6..1e7 (the
    synthetic generator's mJy scale) in channel stripes, time bursts and
    blocks, random phase. Returns (waterfalls, mask)."""
    shape = (N_WATERFALLS, SIDE, SIDE)
    amp = 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
    mask = np.zeros(shape, bool)
    for m in range(N_WATERFALLS):
        for _ in range(3):  # narrowband, persistent
            c = rng.integers(0, SIDE - 4)
            mask[m, c:c + rng.integers(1, 4)] = True
        for _ in range(2):  # broadband burst
            t = rng.integers(0, SIDE - 6)
            mask[m, :, t:t + rng.integers(1, 6)] = True
        for _ in range(2):  # block
            c, t = rng.integers(0, SIDE - 64, 2)
            mask[m, c:c + rng.integers(8, 64), t:t + rng.integers(8, 64)] = True
    rfi = rng.uniform(1e6, 1e7, shape).astype(np.float32)
    amp = np.where(mask, amp + rfi, amp)
    phase = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    return (amp * np.exp(1j * phase)).astype(np.complex64), mask


def cuda_ms(fn, calls=50, windows=5):
    """Milliseconds per call of ``fn`` on the card: ``calls`` calls back to
    back between one pair of CUDA events, with a few calls queued ahead of
    the start event so that the host's share of a call hides behind the
    card's work; the median over ``windows`` such windows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            fn()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def calls_per_s(fn):
    """Calls of ``fn`` per second: each of ``WINDOWS`` windows queues calls
    until ``WINDOW_S`` host seconds have passed, then waits for the card.
    Returns (median rate, lowest, highest, calls in all, result of the last
    call)."""
    rates, n_all = [], 0
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < WINDOW_S:
            out = fn()
            n += 1
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
        n_all += n
    return statistics.median(rates), min(rates), max(rates), n_all, out


def rate_text(rate, lo, hi):
    return f"{rate:.4g} (windows {lo:.4g}-{hi:.4g})"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rfi_toolbox_tpu_torch.evaluation import evaluate_segmentation
    from rfi_toolbox_tpu_torch.io import flag_waterfalls
    from rfi_toolbox_tpu_torch.ops import (
        _lib,
        fused_extract_channels,
        fused_extract_channels_plain,
        mad_flag_patches,
        mad_flag_patches_plain,
    )
    from rfi_toolbox_tpu_torch.preprocess import pipeline as P
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor
    from rfi_toolbox_tpu_torch.utils import set_tf32

    phases = {}
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"device: {kind} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_tf32(False)

    # -- build ------------------------------------------------------------
    t = time.perf_counter()
    lib = _lib.load()
    phases["build"] = time.perf_counter() - t
    log(f"build: nvcc {lib.build_seconds:.1f} s -> {lib.path.name}")

    # -- data ---------------------------------------------------------------
    t = time.perf_counter()
    rng = np.random.default_rng(SEED)
    wf_np, mask_np = make_waterfalls(rng)
    wf = torch.from_numpy(wf_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    patches = P.patchify_batch(wf, PATCH).contiguous()  # (512, 128, 128)
    n_patches = patches.shape[0]
    phases["data"] = time.perf_counter() - t

    # -- K4 -----------------------------------------------------------------
    t = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(SEED)
    real = (3.0 * torch.randn((16, PATCH, PATCH), generator=g)).to(dev)
    cases = {
        "512x128^2": patches,
        "odd N=37": patches[100:137].contiguous(),
        "constant": torch.full((3, PATCH, PATCH), 2 + 1j, dtype=torch.complex64,
                               device=dev),
        "real f32": real,
    }
    k4_err = {}
    for name, x in cases.items():
        got, want = fused_extract_channels(x), fused_extract_channels_plain(x)
        torch.cuda.synchronize()
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"K4 {name}: shape or non-finite output")
        k4_err[name] = float((got - want).abs().max())
    log("K4 max|kernel-plain|: " + ", ".join(
        f"{k} {v:.2e}" for k, v in k4_err.items()) + f" (tol {K4_TOL:g})")
    require(max(k4_err.values()) <= K4_TOL, "K4 disagrees with its plain version")
    k4_ms = cuda_ms(lambda: fused_extract_channels(patches))
    k4_plain_ms = cuda_ms(lambda: fused_extract_channels_plain(patches))
    px = patches.numel()
    k4_bytes = px * (8 + 12)
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, px * K4_OPS_PER_PIXEL / SCALAR_OPS_PER_S)
    log(f"K4 at (512,128,128) c64: kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, "
        f"bound {k4_bound * 1e3:.4f} ms (bytes)")
    phases["K4"] = time.perf_counter() - t

    # -- K5 -----------------------------------------------------------------
    t = time.perf_counter()
    with_nan = patches[:64].clone()
    nan_at = torch.rand(with_nan.shape, generator=g).to(dev) < 0.01
    with_nan[nan_at] = complex(float("nan"), 0.0)
    with_nan[5] = complex(float("nan"), 0.0)  # an all-NaN patch
    negative = real.clone()
    negative[:, :4] -= 50.0
    cases = {
        "512x128^2": patches,
        "whole 1024^2": wf,
        "NaNs": with_nan,
        "negative real": negative,
    }
    k5_diff = {}
    for name, x in cases.items():
        got, want = mad_flag_patches(x, SIGMA), mad_flag_patches_plain(x, SIGMA)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == torch.bool,
                f"K5 {name}: shape or dtype")
        k5_diff[name] = int((got != want).sum())
    log("K5 flags differing from plain: " + ", ".join(
        f"{k} {v}" for k, v in k5_diff.items()) + " (must be 0)")
    require(not any(k5_diff.values()), "K5 flags differ from its plain version")
    k5_ms = cuda_ms(lambda: mad_flag_patches(patches, SIGMA))
    k5_plain_ms = cuda_ms(lambda: mad_flag_patches_plain(patches, SIGMA))
    k5_whole_ms = cuda_ms(lambda: mad_flag_patches(wf, SIGMA), calls=5, windows=3)
    k5_bound = px * (8 + 1) / HBM_BYTES_PER_S
    log(f"K5 at (512,128,128) c64: kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms, "
        f"bound {k5_bound * 1e3:.4f} ms (bytes); design cost "
        f"{px * K5_DESIGN_OPS_PER_PIXEL / 1e9:.2f} G integer ops; whole "
        f"(8,1024,1024) {k5_whole_ms:.4f} ms")
    phases["K5"] = time.perf_counter() - t

    # -- model path ---------------------------------------------------------
    t = time.perf_counter()
    k4_launches = 0
    for path in SNAPSHOTS:
        pred = CompiledPredictor.from_snapshot(path, batch_size=BATCH)
        flag_waterfalls(wf, method="model", predictor=pred)  # warm-up
        torch.cuda.synchronize()
        fused_extract_channels.launches = 0
        mad_flag_patches.launches = 0
        rate, lo, hi, calls, flags = calls_per_s(
            lambda: flag_waterfalls(wf, method="model", predictor=pred))
        launches = fused_extract_channels.launches
        require(launches > 0, f"model path ({path}) never launched K4")
        k4_launches += launches
        require(flags.shape == wf.shape and flags.dtype == torch.bool,
                "model flags: shape or dtype")
        m = evaluate_segmentation(flags, mask)
        images = fused_extract_channels(patches)
        pred_ms = cuda_ms(lambda: pred(images), calls=5, windows=3)
        log(f"model {path.split('/')[-1]}: IoU {m['iou']:.4f} "
            f"P {m['precision']:.4f} R {m['recall']:.4f}; K4 launches "
            f"{launches} in {calls} calls; waterfalls/s on {kind}: "
            f"{rate_text(N_WATERFALLS * rate, N_WATERFALLS * lo, N_WATERFALLS * hi)}, "
            f"patches/s {n_patches * rate:.4g}; call {1e3 / rate:.3f} ms, "
            f"predictor alone {pred_ms:.3f} ms")
        require(m["iou"] > 0.9, f"model flags ({path}) miss the injected RFI")

        gpu = pred.logits(images[:8]).cpu()
        cpu_pred = CompiledPredictor.from_snapshot(path, batch_size=BATCH,
                                                   device="cpu")
        cpu = cpu_pred.logits(images[:8].cpu())
        err = float((gpu - cpu).abs().max())
        log(f"  logits card vs CPU on 8 patches: max abs diff {err:.2e} "
            f"(tol {LOGIT_TOL:g}, |logit| <= {float(cpu.abs().max()):.1f})")
        require(err <= LOGIT_TOL, "card logits disagree with the CPU")
    phases["model"] = time.perf_counter() - t

    # -- MAD path -----------------------------------------------------------
    t = time.perf_counter()
    flag_waterfalls(wf, method="mad", sigma=SIGMA)  # warm-up
    torch.cuda.synchronize()
    fused_extract_channels.launches = 0
    mad_flag_patches.launches = 0
    rate, lo, hi, calls, flags = calls_per_s(
        lambda: flag_waterfalls(wf, method="mad", sigma=SIGMA))
    k5_launches = mad_flag_patches.launches
    require(k5_launches > 0, "MAD path never launched K5")
    m = evaluate_segmentation(flags, mask)
    log(f"mad sigma={SIGMA:g}: IoU {m['iou']:.4f} P {m['precision']:.4f} "
        f"R {m['recall']:.4f}; K5 launches {k5_launches} in {calls} calls; "
        f"waterfalls/s on {kind}: "
        f"{rate_text(N_WATERFALLS * rate, N_WATERFALLS * lo, N_WATERFALLS * hi)}; "
        f"call {1e3 / rate:.4f} ms")
    require(m["iou"] > 0.5, "MAD flags do not find the injected RFI")
    phases["mad"] = time.perf_counter() - t

    log("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
        + f"; total wall time {time.perf_counter() - T_START:.1f} s")
    kernels = [
        {"name": "fused_extract_channels", "route": "cuda",
         "source": "rfi_toolbox_tpu_torch/ops/csrc/fused_channels.cu",
         "replaces": "rfi_toolbox_tpu/ops/fused_channels.py:455",
         "launches": k4_launches, "max_abs_err": max(k4_err.values()),
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound * 1e3,
         "bound_by": "bytes", "library_ms": None},
        {"name": "mad_flag_patches", "route": "cuda",
         "source": "rfi_toolbox_tpu_torch/ops/csrc/mad_flags.cu",
         "replaces": "rfi_toolbox_tpu/ops/mad_flags.py:132",
         "launches": k5_launches, "max_abs_err": float(max(k5_diff.values())),
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound * 1e3,
         "bound_by": "bytes", "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
