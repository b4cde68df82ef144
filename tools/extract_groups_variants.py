#!/usr/bin/env python3
"""Variants of the resident-group extraction kernel, timed on one card.

    python3 tools/extract_groups_variants.py      # from the root of a checkout

Builds copies of ``rfi_toolbox_tpu_torch/ops/csrc/extract_groups.cu`` under
``build/extract_groups_variants/`` with other threads a CTA, CTAs an SM and
shared memory budgets (its ``kThreads``, ``kBlocksPerSm``, ``kSmemBudget``),
with one bulk copy a slab instead of chunks, and with ``%globaltimer``
stamps of each slab's phases, one ``nvcc`` each, all started together. Each
is launched directly (its C entry point through ctypes) at several rows a
slab on the shapes of K4, K2 and K1 above 128 x 128, checked against the
plain version (2e-5) and timed with CUDA events beside the strip kernel
(``extract_strips.cu``). The traced copy prints, per slab, the mean
microseconds of its load and conversion, its squares and keys, its wait
for the patch's other slabs and its pass B. Prints the card's name and
power limit first. Imports nothing of JAX.
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
from rfi_toolbox_tpu_torch.ops import _lib  # noqa: E402
from rfi_toolbox_tpu_torch.ops import fused_channels as F  # noqa: E402

OUT = ROOT / "build" / "extract_groups_variants"


def sub(text, old, new):
    if old not in text:
        raise SystemExit(f"extract_groups_variants: the source no longer holds {old!r}")
    return text.replace(old, new)


def config(text, threads, per_sm, budget_kb):
    text = re.sub(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};", text)
    text = re.sub(r"constexpr int kBlocksPerSm = \d+;",
                  f"constexpr int kBlocksPerSm = {per_sm};", text)
    return re.sub(r"constexpr int kSmemBudget = \d+ \* 1024;",
                  f"constexpr int kSmemBudget = {budget_kb} * 1024;", text)


def one_chunk(text):
    return re.sub(r"  const int chunk_rows = max\([^;]*;",
                  "  const int chunk_rows = slab_rows + 2;", text, flags=re.S)


def traced(text):
    """Stamps T0-T4 of each slab (ticket taken, converted, keys combined,
    released, done) and its CTA into the scratch past the keys."""
    stamp = ("__device__ __forceinline__ unsigned long long stamp() {\n"
             "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
             "  return t;\n}\n\n")
    text = sub(text, "__device__ __forceinline__ unsigned shared_address",
               stamp + "__device__ __forceinline__ unsigned shared_address")
    text = sub(text, "    if (t >= total) break;\n",
               "    if (t >= total) break;\n    const unsigned long long t0 = stamp();\n")
    text = sub(text, "    if (tma) phases ^= (1u << chunks) - 1u;\n    __syncthreads();\n",
               "    if (tma) phases ^= (1u << chunks) - 1u;\n    __syncthreads();\n"
               "    const unsigned long long t1 = stamp();\n")
    text = sub(text, "    // B. wait for the patch's other slabs",
               "    const unsigned long long t2 = stamp();\n"
               "    // B. wait for the patch's other slabs")
    text = sub(text, "    __syncthreads();\n    float lo_b[kSlots], hi_b[kSlots];\n",
               "    __syncthreads();\n    const unsigned long long t3 = stamp();\n"
               "    float lo_b[kSlots], hi_b[kSlots];\n")
    return sub(text, "    __syncthreads();  // the tile, the list and the ticket are reused",
               "    if (tid == 0) {\n"
               "      unsigned long long* tr = reinterpret_cast<unsigned long long*>(\n"
               "          scratch + ((2 + 9 * n) & ~1)) + 6LL * t;\n"
               "      tr[0] = t0, tr[1] = t1, tr[2] = t2, tr[3] = t3, tr[4] = stamp();\n"
               "      tr[5] = blockIdx.x;\n    }\n"
               "    __syncthreads();  // the tile, the list and the ticket are reused")


def build(variants):
    """name -> (ctypes library, resident CTAs of K4 on complex input)."""
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
        report = []
        for part in re.split(r"Compiling entry function", out)[1:]:
            kind = re.search(r"group_extract_kernelILb(\d)ELi(\d)ELi(\d)E", part)
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            if kind and regs:
                report.append(f"<{','.join(kind.groups())}> {regs.group(1)} registers "
                              f"{spill.group(1) if spill else '?'} B spilled")
        lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
        for fn in ("rfi_extract_groups", "rfi_extract_groups_occupancy"):
            getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
        fit = (ctypes.c_int * 3)()
        lib.rfi_extract_groups_occupancy(F._K4, 1, fit)
        print(f"{name}: {fit[0]} CTAs an SM, {fit[1]} on the card, {fit[2]} B a CTA; "
              + "; ".join(report), flush=True)
        libs[name] = (lib, fit[1], fit[2])
    return libs


def main():
    if not torch.cuda.is_available():
        print("extract_groups_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    src = (_lib.CSRC / "extract_groups.cu").read_text()
    libs = build({
        "256x4 (the source)": src,
        "256x4 one bulk copy a slab": one_chunk(src),
        "512x2": config(src, 512, 2, 110),
        "1024x1": config(src, 1024, 1, 220),
        "256x4 traced": traced(src),
    })
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def complex_patches(n, h, w):
        amp = torch.exp(1.5 * torch.randn((n, h, w), generator=g))
        return torch.polar(amp, 6.283 * torch.rand((n, h, w), generator=g)).to(dev)

    wf = complex_patches(8, 1024, 1024)
    p256 = complex_patches(128, 256, 256)
    idx = (torch.randint(0, 128, (480,), generator=g).to(dev).int(),
           torch.randint(0, 3, (480,), generator=g).to(dev).int())
    # name -> (kind, patches, indices, rows a slab)
    shapes = {
        "K4 (128,1024^2)": (F._K4, wf.repeat(16, 1, 1), None, [4, 8, 11, 24]),
        "K4 (32,256^2)": (F._K4, p256[:32].contiguous(), None, [8, 16, 25, 32]),
        "K2 (128,256^2)": (F._K2, p256, None, [8, 16, 25, 52]),
        "K1 M=128 K=480 256^2": (F._K1, p256, idx, [8, 16, 25, 52]),
        "K4 real (8,1024^2)": (F._K4, wf.abs(), None, [8, 11, 24]),
    }
    for sname, (kind, x, ix, rows_list) in shapes.items():
        n, h, w = x.shape
        k = 0 if ix is None else ix[0].numel()
        plane_shapes = [(3, n, h, w), (n, h, w), (n, h, w)]
        out_shapes = {F._K4: [(n, h, w, 3)], F._K2: plane_shapes, F._K1: [(3, k, h, w)]}[kind]
        outs = [torch.empty(s, device=dev) for s in out_shapes]
        buf = outs[0]  # K1: its three planes in one buffer, as its wrapper's
        if kind == F._K1:
            outs = list(buf)
        ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
        want = {F._K4: lambda: (F.fused_extract_channels_plain(x),),
                F._K2: lambda: F.fused_extract_channel_planes_plain(x),
                F._K1: lambda: F.fused_gather_extract_plain(x, *ix)}[kind]()
        planes = [torch.empty(s, device=dev) for s in plane_shapes]
        zeros = None if ix is None else torch.zeros_like(ix[0])

        def strips():
            if kind == F._K4:
                F._extract_strips(F._K4, x, *outs)
                return
            F._extract_strips(F._K2, x, *planes)
            if kind == F._K1:
                F._gather_transform(planes, *ix, zeros, buf, 1)
        print(f"{sname}: strip kernel {C.cuda_ms(strips, calls=10, windows=3):.4f} ms", flush=True)
        for name, (lib, resident, budget) in libs.items():
            for rows in rows_list:
                slabs = -(-h // rows)
                if (rows + 2) * w * (8 if x.is_complex() else 4) > budget or slabs > resident:
                    continue
                scratch = torch.zeros(4 + 9 * n + 12 * n * slabs, dtype=torch.int32, device=dev)

                def call():
                    rc = lib.rfi_extract_groups(
                        kind, x.data_ptr(), *(None if ix is None else i.data_ptr()
                                              for i in (ix or (None, None))),
                        *ptrs, scratch.data_ptr(), n, k, h, w, rows, int(x.is_complex()),
                        _lib.stream_of(x))
                    _lib.check(rc, name)
                call()
                torch.cuda.synchronize()
                err = C.extract_err(outs, want, f"{name} {sname} rows {rows}")
                line = (f"  {name} rows {rows} (G {slabs}, {n * slabs} slabs): "
                        f"{C.cuda_ms(call, calls=10, windows=3):.4f} ms, max|kernel-plain| "
                        f"{err:.1e}")
                if "traced" in name:
                    call()
                    torch.cuda.synchronize()
                    off = (2 + 9 * n) & ~1
                    tr = scratch[off:off + 12 * n * slabs].view(torch.int64).view(-1, 6)
                    d = (tr[:, 1:5] - tr[:, 0:4]).double().cpu() / 1e3
                    load, keys, wait, pass_b = (float(d[:, i].mean()) for i in range(4))
                    line += (f"; a slab's us: load and convert {load:.2f}, squares and keys "
                             f"{keys:.2f}, wait {wait:.2f} ({float(d[:, 2].sum() / d.sum()):.3f} "
                             f"of the slabs' time), pass B {pass_b:.2f}")
                print(line, flush=True)
                del scratch
    return 0


if __name__ == "__main__":
    sys.exit(main())
