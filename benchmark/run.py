#!/usr/bin/env python3
"""The benchmark of rfi_toolbox_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Runs cell NAME of ``BENCHMARK.json`` (see
``benchmark/harness.py``): set-up, a window of S seconds, then the
comparison with the plain reference. With ``--trace 0`` the result holds
the cell's end-to-end metrics; with ``--trace 1`` its per-layer ones,
read from a profiler trace of the window's last stretch. The last line
of standard output is the result, one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key. Exits non-zero, with no result, without a CUDA card,
if JAX or the JAX package was loaded, and where a traced run recorded no
stretch whole.
"""

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "rfi_toolbox_tpu"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    chips = next((w["chips"] for w in harness.spec()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"run.py: unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, args.trace,
                                  t_begin=T_BEGIN)
    except harness.Refused as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 5
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"run.py: modules of JAX or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 4
    print(f"calls in the window: {result['attempted']}", flush=True)
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
