#!/usr/bin/env python3
"""Where the time of the port's training main path goes, on one card.

    python3 tools/torch_train_profile.py [TABLE]   # from the root of a checkout

Builds the main path of ``chip_smoke.py`` phase 9 (8 generated
1024 x 1024 waterfalls, static prep with K=1920, UNet(32, norm="batch")
in bfloat16, 15 steps of 128), runs one warm-up iteration, then traces
one more iteration with ``torch.profiler`` and prints:

- the card's name and power limit (nvidia-smi);
- device time by kernel (top rows) and by class (convolutions,
  BatchNorm, elementwise and reductions, optimiser, the port's kernels,
  copies), with the device's busy and idle share of the iteration;
- generation and static prep alone: each one's host milliseconds a call
  (synchronised, median of 5), and one traced call of both with the
  card's busy share;
- the train-only time per iteration (median of 3).

With a path ``TABLE``, the profiler's full table (60 rows) is written
there. Imports nothing of JAX.
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RFI_CONFIG = {
    "narrowband_persistent": {"count": 20},
    "broadband_persistent": {"count": 5},
    "narrowband_bursty": {"count": 20},
    "broadband_bursty": {"count": 5},
    "frequency_sweep": {"count": 1},
}
SIDE, PATCH, WATERFALLS, K, BATCH = 1024, 128, 8, 1920, 128
CLASSES = (  # first match wins, on the lower-cased kernel name
    ("port kernels", ("cluster_extract", "group_extract", "strip_extract", "init_keys",
                      "plane_gather", "mad_flag")),
    ("convolutions (cuDNN)", ("conv", "xmma", "gemm", "cudnn", "cutlass",
                              "wgrad", "dgrad", "fprop", "nhwc", "nchw")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_")),
    ("optimiser (foreach)", ("foreach", "multi_tensor")),
    ("copies", ("memcpy", "memset", "copy")),
)


def classify(name):
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise, reductions, other"


def device_us(evt):
    """Device time of a kernel row (operator rows, which hold their
    kernels' time too, count 0)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(evt.self_device_time_total)


def main():
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    from rfi_toolbox_tpu_torch.models import UNet
    from rfi_toolbox_tpu_torch.preprocess import Preprocessor
    from rfi_toolbox_tpu_torch.synth import make_sample_generator
    from rfi_toolbox_tpu_torch.train import create_train_state, train_steps

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    sample_fn = make_sample_generator(SIDE, SIDE, rfi_config=RFI_CONFIG)
    state = create_train_state(UNet(init_features=32, norm="batch",
                                    dtype=torch.bfloat16), seed=1)
    steps = K // BATCH

    def dataset(i):
        wf, mask, _ = sample_fn(WATERFALLS, torch.Generator(device=dev).manual_seed(i))
        ds = Preprocessor(wf, flags=mask).create_dataset(
            patch_size=PATCH, seed=0, static_num_patches=K)
        return (ds.images.reshape(steps, BATCH, PATCH, PATCH, 3),
                ds.labels.reshape(steps, BATCH, PATCH, PATCH))

    def iteration(i):
        return train_steps(state, *dataset(i))[1]

    iteration(0)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        iteration(1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    busy = sum(device_us(e) for e in events)
    by_class = {}
    for e in events:
        by_class[classify(e.key)] = by_class.get(classify(e.key), 0.0) + device_us(e)
    print(f"one traced iteration ({steps} steps of {BATCH}, with generation and "
          f"static prep): wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {us / 1e3:.2f} ms ({100 * us / busy:.1f}% of busy)")
    print("top kernels by device time:")
    for e in sorted(events, key=device_us, reverse=True)[:15]:
        print(f"  {device_us(e) / 1e3:8.2f} ms {e.count:6d}x  [{classify(e.key)}] "
              f"{e.key[:110]}")
    if len(sys.argv) > 1:
        table = Path(sys.argv[1])
        table.parent.mkdir(parents=True, exist_ok=True)
        table.write_text(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))

    def host_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    wf, mask, _ = sample_fn(WATERFALLS, torch.Generator(device=dev).manual_seed(3))
    gen_ms = host_ms(lambda: sample_fn(WATERFALLS, torch.Generator(device=dev).manual_seed(3)))
    prep_ms = host_ms(lambda: Preprocessor(wf, flags=mask).create_dataset(
        patch_size=PATCH, seed=0, static_num_patches=K))
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        dataset(4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(device_us(e) for e in prof.key_averages())
    print(f"generation {gen_ms:.2f} ms, static prep {prep_ms:.2f} ms a call (host clock, "
          f"synchronised); one traced call of both: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%)")

    images, labels = dataset(2)

    def train_ms():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_steps(state, images, labels)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    print(f"train only: {train_ms():.1f} ms per {steps} steps of {BATCH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
