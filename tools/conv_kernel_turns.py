#!/usr/bin/env python3
"""Time K6b (conv3x3_dw) and K7 (double_conv_gn_relu) of one or more
checkouts of the port on one card, in turns.

    python3 tools/conv_kernel_turns.py                       # this checkout
    python3 tools/conv_kernel_turns.py build/old . . build/old
    python3 tools/conv_kernel_turns.py --json out.json build/old . . build/old

Each ROOT is a checkout (the repo root, or an older tree unpacked under
the git-ignored build/); each is run in its own process, in the order
given, so that old, new, new, old compares two versions on one card
within one call. A process imports ``rfi_toolbox_tpu_torch`` from its
ROOT, builds that tree's kernels into ROOT/build/torch_kernels, and at
batch 128 times:

- K6b on the 18 conv3x3 layers of UNet(32) (128 x 128 input, depth 4),
- K7 on the 9 DoubleConvs of UNet(16, norm="group"), 8 groups,

on seeded random inputs (the kernels do the same work whatever the
values), each against its plain PyTorch version (TF32 off) for the
error, as a share of the output's max. The layer shapes are read by
forward hooks from ROOT's own models; the timing (``cuda_ms``) and the
direct-equivalent GFLOP (``direct_gflop``) are this checkout's
``chip_smoke.py``'s. Prints the card's name and power limit, one line
per layer and run, and the sums; with ``--json PATH`` also writes every
number to PATH. Imports nothing of JAX.

These are screening figures for comparing versions within one call:
the numbers of record are ``chip_smoke.py``'s, on the path's own
activations and gradients.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

BATCH = 128
SIDE = 128
REPO = Path(__file__).resolve().parents[1]


def load_chip_smoke():
    """This checkout's chip_smoke.py, whatever ROOT is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def shapes_of(torch, model, kind):
    """(side, ci, co) of each module of ``kind`` in ``model``, in forward
    order, from forward hooks on one SIDE x SIDE image."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, inputs, out: seen.append((out.shape[2], inputs[0].shape[1], out.shape[1])))
        for m in model.modules() if kind(m)]
    with torch.no_grad():
        model(torch.zeros(1, 3, SIDE, SIDE))
    for h in hooks:
        h.remove()
    return seen


def worker(root):
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from rfi_toolbox_tpu_torch import ops
    from rfi_toolbox_tpu_torch.models.unet import DoubleConv, UNet
    from rfi_toolbox_tpu_torch.utils import set_tf32

    smoke = load_chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("conv_kernel_turns: no CUDA device")
    set_tf32(False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = ops._lib.load()
    rows = {"K6b": [], "K7": []}

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def ms(fn):
        return smoke.cuda_ms(fn, calls=10, windows=3)

    def is_conv3x3(m):
        return isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3)

    for s, ci, co in shapes_of(torch, UNet(init_features=32, norm="batch"), is_conv3x3):
        x = torch.randn(BATCH, s, s, ci, device=dev, generator=gen)
        g = torch.randn(BATCH, s, s, co, device=dev, generator=gen)
        rows["K6b"].append({
            "shape": f"({BATCH},{s},{s},{ci})x({co})",
            "gflop": smoke.direct_gflop(BATCH, s, s, ci, co),
            "err": err(ops.conv3x3_dw(x, g), ops.conv3x3_dw_plain(x, g)),
            "ms": ms(lambda: ops.conv3x3_dw(x, g))})
        del x, g
    gn_unet = UNet(init_features=16, norm="group")
    for s, ci, co in shapes_of(torch, gn_unet, lambda m: isinstance(m, DoubleConv)):
        x = torch.relu(torch.randn(BATCH, s, s, ci, device=dev, generator=gen))
        w1 = torch.randn(3, 3, ci, co, device=dev, generator=gen) / (9 * ci) ** 0.5
        w2 = torch.randn(3, 3, co, co, device=dev, generator=gen) / (9 * co) ** 0.5
        g1, g2 = (1 + 0.3 * torch.randn(co, device=dev, generator=gen) for _ in range(2))
        b1, b2 = (0.3 * torch.randn(co, device=dev, generator=gen) for _ in range(2))
        args = (x, w1, g1, b1, w2, g2, b2)
        rows["K7"].append({
            "shape": f"({BATCH},{s},{s},{ci})->{co}",
            "gflop": smoke.direct_gflop(BATCH, s, s, ci, co) + smoke.direct_gflop(BATCH, s, s, co, co),
            "err": err(ops.double_conv_gn_relu(*args, num_groups=8),
                       ops.double_conv_gn_relu_plain(*args, num_groups=8)),
            "ms": ms(lambda: ops.double_conv_gn_relu(*args, num_groups=8))})
        del x, args
    print(json.dumps({"root": root, "build_s": lib.build_seconds,
                      "device": torch.cuda.get_device_name(0), "rows": rows}), flush=True)


def main(roots, json_path=None):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for i, root in enumerate(roots):
        out = subprocess.run([sys.executable, __file__, "--worker", root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"conv_kernel_turns: run {i} ({root}) failed")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        for name, rows in run["rows"].items():
            for r in rows:
                print(f"run {i} {root} {name} {r['shape']}: {r['ms']:.4f} ms, "
                      f"{r['gflop'] / r['ms']:.1f} TFLOP/s direct, err {r['err']:.1e}")
            total = sum(r["ms"] for r in rows)
            gflop = sum(r["gflop"] for r in rows)
            print(f"run {i} {root} {name} sum: {total:.3f} ms ({gflop / total:.1f} TFLOP/s "
                  f"direct), worst err {max(r['err'] for r in rows):.1e}; build "
                  f"{run['build_s']:.1f} s", flush=True)
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    summary = {name: [round(sum(r["ms"] for r in run["rows"][name]), 4) for run in runs]
               for name in ("K6b", "K7")}
    print(json.dumps({"card": smi, "roots": roots, "sum_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    else:
        args = sys.argv[1:]
        out = None
        if args[:1] == ["--json"]:
            out, args = args[1], args[2:]
        sys.exit(main(args or ["."], out))
