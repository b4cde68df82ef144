#!/usr/bin/env python3
"""Which device kernels cuDNN runs for the float32 3x3 convolutions that
K6a, K6b and K7 are measured against, on one card.

    python3 tools/conv_library_kernels.py      # from the root of a checkout

For a few layer shapes of the UNets at batch 128 (NHWC memory, TF32 off,
as ``chip_smoke.py`` times them) it traces, with ``torch.profiler``, 10
calls each of cuDNN's fused conv+bias+ReLU (``torch.cudnn_convolution_relu``,
K6a's yardstick) and its weight-gradient-only backward
(``aten.convolution_backward``, K6b's), and of K6a and K6b themselves, and
prints per call: device time, the direct-convolution rate that time
implies (2 * 9 * Ci * Co flops per pixel), and the names of the kernels
that ran. A rate above the 67 TFLOP/s float32 peak means the library did
fewer operations (Winograd, FFT) or used the tensor cores. Imports nothing
of JAX.
"""

import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [(128, 128, 3, 32), (128, 128, 32, 32), (128, 64, 64, 64),
          (128, 16, 512, 256), (128, 8, 512, 512)]  # (n, side, ci, co)
CALLS = 10


def device_us(evt):
    for name in ("device_time_total", "cuda_time_total", "self_device_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def traced(fn):
    """(device ms per call, kernel names) of CALLS calls of fn."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if device_us(e) > 0 and e.device_type.name == "CUDA"]
    total = sum(device_us(e) for e in rows) / 1e3 / CALLS
    return total, sorted({e.key[:90] for e in rows})


def main():
    if not torch.cuda.is_available():
        print("conv_library_kernels: no CUDA device", file=sys.stderr)
        return 1
    from rfi_toolbox_tpu_torch import ops
    from rfi_toolbox_tpu_torch.utils import set_tf32

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}", flush=True)
    set_tf32(False)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for n, side, ci, co in SHAPES:
        x = torch.randn(n, side, side, ci, device=dev, generator=g)
        gy = torch.randn(n, side, side, co, device=dev, generator=g)
        w = torch.randn(3, 3, ci, co, device=dev, generator=g) / (3 * ci ** 0.5)
        b = torch.randn(co, device=dev, generator=g)
        xl, gl = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        gflop = 2 * n * side * side * 9 * ci * co / 1e9
        cases = {
            "cuDNN conv+bias+ReLU": lambda: torch.cudnn_convolution_relu(
                xl, wl, b, (1, 1), (1, 1), (1, 1), 1),
            "K6a": lambda: ops.conv3x3_call(x, w, b, relu=True),
            "cuDNN weight gradient": lambda: torch.ops.aten.convolution_backward(
                gl, xl, wl, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False]),
            "K6b": lambda: ops.conv3x3_dw(x, gy),
        }
        for name, fn in cases.items():
            ms, kernels = traced(fn)
            print(f"({n},{side},{side},{ci})->{co} {name}: {ms:.4f} ms, "
                  f"{gflop / ms:.1f} TFLOP/s direct-equivalent; kernels: "
                  + "; ".join(kernels), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
