#!/usr/bin/env python3
"""Time K6a (conv3x3_call), K6b (conv3x3_dw), K7 (double_conv_gn_relu),
K5 (mad_flag_patches), K1 (fused_gather_extract), K2
(fused_extract_channel_planes), K3 (fused_plane_gather_transform) and K4
(fused_extract_channels) of one or more checkouts of the port on one card,
in turns, and the paths that run K1, K2, K3 and K4.

    python3 tools/conv_kernel_turns.py                       # this checkout
    python3 tools/conv_kernel_turns.py build/old . . build/old
    python3 tools/conv_kernel_turns.py --json out.json build/old . . build/old
    python3 tools/conv_kernel_turns.py --only K6a,K5 build/old . . build/old

Each ROOT is a checkout (the repo root, or an older tree unpacked under
the git-ignored build/); each is run in its own process, in the order
given, so that old, new, new, old compares two versions on one card
within one call. A process imports ``rfi_toolbox_tpu_torch`` from its
ROOT, builds that tree's kernels into ROOT/build/torch_kernels, and at
batch 128 times:

- K6a on the 18 conv3x3 layers of UNet(16) (the folded UNet16 predictor's
  convs, with bias and ReLU), as "K6a", and on the 17 dx convolutions of
  UNet(32)'s training step (every layer but the 3-channel first one: the
  output gradient through the rotated weights, no bias, no ReLU), as
  "K6a_dx",
- K6b on the 18 conv3x3 layers of UNet(32) (128 x 128 input, depth 4),
- K7 on the 9 DoubleConvs of UNet(16, norm="group"), 8 groups,
- K5 on 512 complex64 patches of 128 x 128 (noise and RFI stripes) at
  sigma 5, as "K5", on 512 such patches all of one value (the worst case
  for its histograms' atomics), as "K5_equal", and on 8 whole 1024 x 1024
  waterfalls, as "K5_whole",
- K2 and K4 on the same 512 patches, K1 on them with K=1920 outputs: a
  random 1920 of the 2048 virtual patches (512 base patches x 4
  variants), so that base patches repeat, at most 4 times, and the
  (base, gradient plane) pair repeats where variants orig and T meet
  (the shape of the training path's static selection), and K3 on their
  K2 planes at the same selection with its variants: the wrapper (three
  planes) and, where the checkout has it, the images wrapper, as "K3",
- above 128 x 128, on ``chip_smoke.make_waterfalls``' 8 complex64
  waterfalls of 1024 x 1024 and their masks (``PERF.md``'s rows): K4 at
  (32, 256, 256) and (128, 1024, 1024), as "K4_large", K2 at (128, 256,
  256), as "K2_large", K1 at the static selection of patch 256 (M=128,
  K=480), as "K1_large", K3 there (as "K3"), as "K3_large";
- the paths that run them (no error; ms a call of the host's clock, the
  rate beside it): ``flag_waterfalls(method="model", patch_size=256)``
  with the UNet16 snapshot (``chip_smoke.py`` phase 5's call), as
  "model_256"; ``Preprocessor.create_dataset`` at patch 256, K=480, on
  the 'auto' (K1) and 'planes' (K2 + K3) routes (phase 8's calls), as
  "prep_256", and at patch 128, K=1920 (phase 8's and the training
  path's), as "prep_128"; ``RawPatchTrainer`` (UNet32 bf16, batch 32) on
  ``DevicePreprocessor``'s 256 x 256 patches (phase 15), 20 warm epochs,
  as "raw_patch",

on seeded random inputs (the convolutions do the same work whatever the
values), each against its plain PyTorch version (TF32 off) for the
error, as a share of the output's max (K5: the count of flags that
differ; K1, K2, K4: the max abs difference, their gate). ``--only``
names the kernels to time (default: all). The layer shapes are read by
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
import time
from pathlib import Path

BATCH = 128
SIDE = 128
LARGE, K_LARGE = 256, 480  # patches above 128 x 128: the static selection's
KERNELS = ("K6a", "K6a_dx", "K6b", "K7", "K5", "K5_equal", "K5_whole", "K1", "K2", "K3",
           "K4", "K4_large", "K2_large", "K1_large", "K3_large", "model_256", "prep_128",
           "prep_256", "raw_patch")
PATHS = ("model_256", "prep_128", "prep_256", "raw_patch")
REPO = Path(__file__).resolve().parents[1]
SNAPSHOT = REPO / "pretrained" / "unet16_synthetic.npz"


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


def worker(root, only):
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from rfi_toolbox_tpu_torch import ops
    from rfi_toolbox_tpu_torch.models.unet import DoubleConv, UNet
    from rfi_toolbox_tpu_torch.ops.conv3x3 import rotate_weight
    from rfi_toolbox_tpu_torch.utils import set_tf32

    smoke = load_chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("conv_kernel_turns: no CUDA device")
    set_tf32(False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = ops._lib.load()
    rows = {name: [] for name in only}

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def ms(fn):
        return smoke.cuda_ms(fn, calls=10, windows=3)

    def is_conv3x3(m):
        return isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    unet32 = shapes_of(torch, UNet(init_features=32, norm="batch"), is_conv3x3)
    if "K6a" in only:
        for s, ci, co in shapes_of(torch, UNet(init_features=16, norm="batch"), is_conv3x3):
            x = torch.relu(randn(BATCH, s, s, ci))
            w, b = randn(3, 3, ci, co) / (9 * ci) ** 0.5, 0.3 * randn(co)
            rows["K6a"].append({
                "shape": f"({BATCH},{s},{s},{ci})->{co}",
                "gflop": smoke.direct_gflop(BATCH, s, s, ci, co),
                "err": err(ops.conv3x3_call(x, w, b, relu=True),
                           ops.conv3x3_call_plain(x, w, b, relu=True)),
                "ms": ms(lambda: ops.conv3x3_call(x, w, b, relu=True))})
            del x
    if "K6a_dx" in only:
        for s, ci, co in unet32[1:]:
            g, wr = randn(BATCH, s, s, co), rotate_weight(randn(3, 3, ci, co) / (9 * ci) ** 0.5)
            rows["K6a_dx"].append({
                "shape": f"({BATCH},{s},{s},{co})->{ci}",
                "gflop": smoke.direct_gflop(BATCH, s, s, co, ci),
                "err": err(ops.conv3x3_call(g, wr), ops.conv3x3_call_plain(g, wr)),
                "ms": ms(lambda: ops.conv3x3_call(g, wr))})
            del g
    if "K6b" in only:
        for s, ci, co in unet32:
            x, g = randn(BATCH, s, s, ci), randn(BATCH, s, s, co)
            rows["K6b"].append({
                "shape": f"({BATCH},{s},{s},{ci})x({co})",
                "gflop": smoke.direct_gflop(BATCH, s, s, ci, co),
                "err": err(ops.conv3x3_dw(x, g), ops.conv3x3_dw_plain(x, g)),
                "ms": ms(lambda: ops.conv3x3_dw(x, g))})
            del x, g
    if "K7" in only:
        gn_unet = UNet(init_features=16, norm="group")
        for s, ci, co in shapes_of(torch, gn_unet, lambda m: isinstance(m, DoubleConv)):
            x = torch.relu(randn(BATCH, s, s, ci))
            w1 = randn(3, 3, ci, co) / (9 * ci) ** 0.5
            w2 = randn(3, 3, co, co) / (9 * co) ** 0.5
            g1, g2 = (1 + 0.3 * randn(co) for _ in range(2))
            b1, b2 = (0.3 * randn(co) for _ in range(2))
            args = (x, w1, g1, b1, w2, g2, b2)
            rows["K7"].append({
                "shape": f"({BATCH},{s},{s},{ci})->{co}",
                "gflop": smoke.direct_gflop(BATCH, s, s, ci, co)
                + smoke.direct_gflop(BATCH, s, s, co, co),
                "err": err(ops.double_conv_gn_relu(*args, num_groups=8),
                           ops.double_conv_gn_relu_plain(*args, num_groups=8)),
                "ms": ms(lambda: ops.double_conv_gn_relu(*args, num_groups=8))})
            del x, args
    if "K5" in only:
        amp = 1 + 0.1 * randn(512, SIDE, SIDE)
        amp[:, 40:43] += 1e6  # a stripe to flag in every patch
        z = torch.polar(amp, 6.3 * torch.rand(amp.shape, device=dev, generator=gen))
        flags = ops.mad_flag_patches(z, 5.0)
        rows["K5"].append({
            "shape": "(512,128,128) complex64", "gflop": 0.0,
            "err": float((flags != ops.mad_flag_patches_plain(z, 5.0)).sum()),
            "ms": ms(lambda: ops.mad_flag_patches(z, 5.0))})
    if "K5_equal" in only:
        z = torch.full((512, SIDE, SIDE), 3 + 4j, dtype=torch.complex64, device=dev)
        flags = ops.mad_flag_patches(z, 5.0)
        rows["K5_equal"].append({
            "shape": "(512,128,128) complex64, all equal", "gflop": 0.0,
            "err": float((flags != ops.mad_flag_patches_plain(z, 5.0)).sum()),
            "ms": ms(lambda: ops.mad_flag_patches(z, 5.0))})
    if "K5_whole" in only:
        amp = 1 + 0.1 * randn(8, 8 * SIDE, 8 * SIDE)
        amp[:, 100:103] += 1e6
        z = torch.polar(amp, 6.3 * torch.rand(amp.shape, device=dev, generator=gen))
        flags = ops.mad_flag_patches(z, 5.0)
        rows["K5_whole"].append({
            "shape": "(8,1024,1024) complex64", "gflop": 0.0,
            "err": float((flags != ops.mad_flag_patches_plain(z, 5.0)).sum()),
            "ms": smoke.cuda_ms(lambda: ops.mad_flag_patches(z, 5.0), calls=3, windows=3)})
    if {"K1", "K2", "K3", "K4"} & set(only):
        amp = 1 + 0.1 * randn(512, SIDE, SIDE)
        amp[:, 40:43] += 1e6
        z = torch.polar(amp, 6.3 * torch.rand(amp.shape, device=dev, generator=gen))
        virtual = torch.randperm(4 * 512, device=dev, generator=gen)[:1920]
        base_idx = virtual % 512
        pidx = torch.tensor([0, 1, 0, 2], device=dev)[virtual // 512]

        def abs_err(got, want):
            return max(float((g - w).abs().max()) for g, w in zip(got, want))
        cases = {"K1": (ops.fused_gather_extract, ops.fused_gather_extract_plain,
                        (z, base_idx, pidx), "(512,128,128) complex64, K=1920"),
                 "K2": (ops.fused_extract_channel_planes,
                        ops.fused_extract_channel_planes_plain, (z,),
                        "(512,128,128) complex64"),
                 "K4": (ops.fused_extract_channels, ops.fused_extract_channels_plain,
                        (z,), "(512,128,128) complex64")}
        for name, (fn, plain, args, shape) in cases.items():
            if name in only:
                got, want = fn(*args), plain(*args)
                got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                rows[name].append({"shape": shape, "gflop": 0.0, "err": abs_err(got, want),
                                   "ms": smoke.cuda_ms(lambda: fn(*args))})
        if "K3" in only:
            planes = ops.fused_extract_channel_planes(z)
            gather_rows(torch, smoke, ops, rows["K3"], (planes, base_idx, pidx, virtual // 512),
                        "(512,128,128) planes, K=1920")
    if {"K4_large", "K2_large", "K1_large", "K3_large", *PATHS} & set(only):
        large(torch, smoke, only, rows)
    print(json.dumps({"root": root, "build_s": lib.build_seconds,
                      "device": torch.cuda.get_device_name(0), "rows": rows}), flush=True)


def gather_rows(torch, smoke, ops, rows, args, shape, calls=50):
    """K3's wrapper (three planes) and, where the checkout has it, its
    images wrapper on ``args`` into ``rows``; err: the elements that
    differ from the plain version."""
    want = ops.fused_plane_gather_transform_plain(*args)
    got = ops.fused_plane_gather_transform(*args)
    rows.append({"shape": shape + ", planes", "gflop": 0.0,
                 "err": float(sum(int((g != w).sum()) for g, w in zip(got, want))),
                 "ms": smoke.cuda_ms(lambda: ops.fused_plane_gather_transform(*args),
                                     calls=calls)})
    if hasattr(ops, "fused_plane_gather_transform_images"):
        images = ops.fused_plane_gather_transform_images(*args)
        rows.append({"shape": shape + ", images", "gflop": 0.0,
                     "err": float((images != torch.stack(want, -1)).sum()),
                     "ms": smoke.cuda_ms(lambda: ops.fused_plane_gather_transform_images(*args),
                                         calls=calls)})


def large(torch, smoke, only, rows):
    """The ``only`` of K4_large, K2_large, K1_large and the paths into
    ``rows``."""
    import numpy as np

    from rfi_toolbox_tpu_torch import ops
    from rfi_toolbox_tpu_torch.io import flag_waterfalls
    from rfi_toolbox_tpu_torch.models import UNet
    from rfi_toolbox_tpu_torch.preprocess import DevicePreprocessor, Preprocessor
    from rfi_toolbox_tpu_torch.preprocess import pipeline as P
    from rfi_toolbox_tpu_torch.preprocess.static_prep import make_static_prep_fn
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor
    from rfi_toolbox_tpu_torch.train import RawPatchTrainer

    dev = torch.device("cuda")
    wf_np, mask_np = smoke.make_waterfalls(np.random.default_rng(smoke.SEED))
    wf, mask = torch.from_numpy(wf_np).to(dev), torch.from_numpy(mask_np).to(dev)
    prep = make_static_prep_fn(LARGE, K_LARGE, return_patches=False)
    sel = prep.base(wf, mask)
    keep = P.static_select_from_has(sel.has, K_LARGE, torch.Generator(device=dev).manual_seed(0))
    base_idx, variant, pidx = prep.indices(sel, keep)
    base = sel.base.contiguous()
    p256 = P.patchify_batch(wf, LARGE).contiguous()

    def kernel(name, fn, plain, args, shape, calls=50):
        got, want = fn(*args), plain(*args)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        rows[name].append({"shape": shape, "gflop": 0.0,
                           "err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                           "ms": smoke.cuda_ms(lambda: fn(*args), calls=calls)})
    if "K4_large" in only:
        kernel("K4_large", ops.fused_extract_channels, ops.fused_extract_channels_plain,
               (p256[:32],), "(32,256,256) complex64")
        kernel("K4_large", ops.fused_extract_channels, ops.fused_extract_channels_plain,
               (wf.repeat(16, 1, 1),), "(128,1024,1024) complex64", calls=10)
    if "K2_large" in only:
        kernel("K2_large", ops.fused_extract_channel_planes,
               ops.fused_extract_channel_planes_plain, (base,),
               f"({base.shape[0]},256,256) complex64")
    if "K1_large" in only:
        kernel("K1_large", ops.fused_gather_extract, ops.fused_gather_extract_plain,
               (base, base_idx, pidx), f"M={base.shape[0]}, K={K_LARGE}, 256^2 complex64")
    if "K3_large" in only:
        gather_rows(torch, smoke, ops, rows["K3_large"],
                    (ops.fused_extract_channel_planes(base), base_idx, pidx, variant),
                    f"M={base.shape[0]}, K={K_LARGE}, 256^2")
    if "model_256" in only:
        pred = CompiledPredictor.from_snapshot(str(SNAPSHOT), batch_size=smoke.FLAG_BATCH_LARGE,
                                               input_shape=(LARGE, LARGE, 3))

        def flag():
            flag_waterfalls(wf, method="model", predictor=pred, patch_size=LARGE)
        flag()  # warm-up
        rate, lo, hi, _, _ = smoke.calls_per_s(flag)
        n = wf.shape[0]
        rows["model_256"].append({
            "shape": f"8 x 1024^2, {n * rate:.4g} ({n * lo:.4g}-{n * hi:.4g}) waterfalls/s",
            "gflop": 0.0, "err": None, "ms": 1e3 / rate})
    for name, side, k in (("prep_128", SIDE, smoke.K_STATIC), ("prep_256", LARGE, K_LARGE)):
        if name not in only:
            continue
        for route in ("auto", "planes"):
            def run():
                Preprocessor(wf[:, None], flags=mask[:, None]).create_dataset(
                    patch_size=side, seed=0, extract=route, use_custom_flags=True,
                    static_num_patches=k)
            run()
            rows[name].append({"shape": f"'{route}', K={k}", "gflop": 0.0,
                               "err": None, "ms": smoke.host_ms(run, repeats=5)})
    if "raw_patch" in only:
        raw, raw_masks = DevicePreprocessor(wf, mask).create_raw_patches(seed=0)
        trainer = RawPatchTrainer(UNet(init_features=32, norm="batch", dtype=torch.bfloat16),
                                  seed=1)
        batch = smoke.RAW_BATCH
        trainer.fit(raw, raw_masks, num_epochs=1, batch_size=batch)  # cuDNN set-up
        torch.cuda.synchronize()
        steps0, t0 = trainer.state.step, time.perf_counter()
        trainer.fit(raw, raw_masks, num_epochs=smoke.RAW_WARM_EPOCHS, batch_size=batch)
        torch.cuda.synchronize()
        seconds, steps = time.perf_counter() - t0, trainer.state.step - steps0
        rows["raw_patch"].append({
            "shape": f"UNet32 bf16, batch {batch}, {steps * batch / seconds:.1f} patches/s",
            "gflop": 0.0, "err": None, "ms": 1e3 * seconds / steps})


def main(roots, only, json_path=None):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for i, root in enumerate(roots):
        out = subprocess.run([sys.executable, __file__, "--worker", root, ",".join(only)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"conv_kernel_turns: run {i} ({root}) failed")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        for name, rows in run["rows"].items():
            for r in rows:
                rate = f", {r['gflop'] / r['ms']:.1f} TFLOP/s direct" if r["gflop"] else ""
                err = "" if r["err"] is None else f", err {r['err']:.1e}"
                print(f"run {i} {root} {name} {r['shape']}: {r['ms']:.4f} ms{rate}{err}")
            total = sum(r["ms"] for r in rows)
            gflop = sum(r["gflop"] for r in rows)
            rate = f" ({gflop / total:.1f} TFLOP/s direct)" if gflop else ""
            errs = [r["err"] for r in rows if r["err"] is not None]
            worst = f", worst err {max(errs):.1e}" if errs else ""
            print(f"run {i} {root} {name} sum: {total:.4f} ms{rate}{worst}; "
                  f"build {run['build_s']:.1f} s", flush=True)
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    summary = {name: [round(sum(r["ms"] for r in run["rows"][name]), 4) for run in runs]
               for name in only}
    print(json.dumps({"card": smi, "roots": roots, "sum_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3].split(","))
    else:
        args = sys.argv[1:]
        out, only = None, list(KERNELS)
        while args[:1] in (["--json"], ["--only"]):
            if args[0] == "--json":
                out = args[1]
            else:
                only = args[1].split(",")
                unknown = set(only) - set(KERNELS)
                if unknown:
                    raise SystemExit(f"conv_kernel_turns: unknown kernels {sorted(unknown)}")
            args = args[2:]
        sys.exit(main(args or ["."], only, out))
