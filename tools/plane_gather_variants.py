#!/usr/bin/env python3
"""Variants of K3's kernel (``csrc/plane_gather.cu``), timed on one card.

    python3 tools/plane_gather_variants.py      # from the root of a checkout

Builds copies of ``rfi_toolbox_tpu_torch/ops/csrc/plane_gather.cu`` under
``build/plane_gather_variants/`` with other counts of stages in flight and
CTAs an SM (its ``kStages``, ``kBlocksPerSm``), with plain stores in
place of its streaming (evict-first) ones, and with other L2 promotions of
its TMA loads, one ``nvcc`` each, all started together. Each is launched
directly (its C entry point through ctypes) on the shapes the static path
gives K3: the K2 planes of 512 base patches of
128 x 128 with a static selection of K=1920 (a random 1920 of the 2048
(base patch, variant) pairs), and of 128 base patches of 256 x 256 with
K=480, as three planes and as images, and in identity mode on the 1920
gathered planes into images (the 'auto' route's call); each output is
checked bit-equal to the plain version and timed with CUDA events
(``chip_smoke.cuda_ms``) beside ``torch.Tensor.copy_`` of the images'
bytes. Prints the card's name and power limit first. Imports nothing of
JAX.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from rfi_toolbox_tpu_torch import ops  # noqa: E402
from rfi_toolbox_tpu_torch.ops import _lib  # noqa: E402
from rfi_toolbox_tpu_torch.ops import fused_channels as F  # noqa: E402

OUT = ROOT / "build" / "plane_gather_variants"


def config(text, stages, per_sm):
    text = re.sub(r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};", text)
    return re.sub(r"constexpr int kBlocksPerSm = \d+;", f"constexpr int kBlocksPerSm = {per_sm};",
                  text)


def promotion(text, kind):
    return text.replace("CU_TENSOR_MAP_L2_PROMOTION_L2_128B", f"CU_TENSOR_MAP_L2_PROMOTION_{kind}")


def plain_stores(text):
    helper = ("template <class T>\n__device__ __forceinline__ void st_plain(T* p, T v) { *p = v; }"
              "\n\n__device__ __forceinline__ unsigned shared_address")
    text = text.replace("__device__ __forceinline__ unsigned shared_address", helper, 1)
    return text.replace("__stcs(", "st_plain(")


def build(variants):
    """name -> ctypes library."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _lib._nvcc()
    procs = {}
    for name, text in variants.items():
        stem = re.sub(r"\W+", "_", name)
        (OUT / f"{stem}.cu").write_text(text)
        cmd = [nvcc, *_lib.NVCC_FLAGS, f"-I{_lib.CSRC}", "-shared", str(OUT / f"{stem}.cu"),
               "-o", str(OUT / f"{stem}.so")]
        procs[name] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", out)
        lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
        for fn in ("rfi_fused_plane_gather_transform", "rfi_plane_gather_occupancy"):
            getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
        fit = (ctypes.c_int * 3)()
        lib.rfi_plane_gather_occupancy(1, 3, fit)
        print(f"{name}: {fit[0]} CTAs an SM (TMA, images), {fit[1]} on the card, {fit[2]} B "
              f"dynamic a CTA; registers {'/'.join(regs)}", flush=True)
        libs[name] = lib
    return libs


def launch(lib, planes, idx, out, stride):
    grad, amp, phase = planes
    base_idx, pidx, variant = idx
    m, h, w = amp.shape
    rc = lib.rfi_fused_plane_gather_transform(
        grad.data_ptr(), amp.data_ptr(), phase.data_ptr(),
        None if base_idx is None else base_idx.data_ptr(),
        None if pidx is None else pidx.data_ptr(), variant.data_ptr(), out.data_ptr(),
        m, variant.numel(), h, w, stride, int(variant.dtype == torch.int64),
        _lib.stream_of(amp))
    _lib.check(rc, "plane_gather variant")


def main():
    if not torch.cuda.is_available():
        print("plane_gather_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    src = (_lib.CSRC / "plane_gather.cu").read_text()
    libs = build({
        "2 stages x 4 CTAs (the source)": src,
        "3 stages x 3 CTAs": config(src, 3, 3),
        "4 stages x 2 CTAs": config(src, 4, 2),
        "2 stages x 4 CTAs, plain stores": plain_stores(src),
        "2 stages x 4 CTAs, L2 promotion 256 B": promotion(src, "L2_256B"),
        "2 stages x 4 CTAs, no L2 promotion": promotion(src, "NONE"),
    })
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = {}
    for m, side, k in ((512, 128, 1920), (128, 256, 480)):
        amp = 1 + 0.1 * torch.randn((m, side, side), device=dev, generator=g)
        z = torch.polar(amp, 6.3 * torch.rand(amp.shape, device=dev, generator=g))
        planes = ops.fused_extract_channel_planes(z)
        virtual = torch.randperm(4 * m, device=dev, generator=g)[:k]
        base_idx, variant = virtual % m, virtual // m
        pidx = torch.tensor([0, 1, 0, 2], device=dev)[variant]
        shapes[f"M={m}, K={k}, {side}^2"] = (planes, (base_idx, pidx, variant))
    for shape, (planes, idx) in shapes.items():
        k, side = idx[0].numel(), planes[1].shape[1]
        want = ops.fused_plane_gather_transform_plain(planes, *idx)
        want_images = torch.stack(want, -1)
        gathered = tuple(x.contiguous() for x in F._gather_planes(planes, *idx[:2]))
        out1 = torch.empty((3, k, side, side), device=dev)
        out3 = torch.empty((k, side, side, 3), device=dev)
        src_bytes = torch.empty(k * side * side * 3, device=dev)
        dst_bytes = torch.empty_like(src_bytes)
        print(f"{shape}: copy_ of the images' bytes "
              f"{C.cuda_ms(lambda: dst_bytes.copy_(src_bytes)):.4f} ms", flush=True)
        cases = {"planes": (planes, idx, out1, 1, torch.stack(want)),
                 "images": (planes, idx, out3, 3, want_images),
                 "identity images": (gathered, (None, None, idx[2]), out3, 3, want_images)}
        for name, lib in libs.items():
            cells = []
            for case, (pl, ix, out, stride, expect) in cases.items():
                out.fill_(float("nan"))
                launch(lib, pl, ix, out, stride)
                torch.cuda.synchronize()
                differ = C.differing((out,), (expect,))
                ms = C.cuda_ms(lambda: launch(lib, pl, ix, out, stride))
                cells.append(f"{case} {ms:.4f} ms ({differ} differing)")
            print(f"  {name}: " + ", ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
