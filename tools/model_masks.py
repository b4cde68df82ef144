#!/usr/bin/env python3
"""Compare the model path's flags of two or more checkouts of the port on
one card.

    python3 tools/model_masks.py build/old .

Each ROOT is a checkout (the repo root, or an older tree unpacked under
the git-ignored build/), run in its own process in the order given. A
process imports ``rfi_toolbox_tpu_torch`` from its ROOT, builds that
tree's kernels into ROOT/build/torch_kernels, and flags
``chip_smoke.py``'s 8 waterfalls of 1024 x 1024 (this checkout's
``make_waterfalls`` and seed) with ``flag_waterfalls(method="model")``
through each shipped UNet16 snapshot, as ``chip_smoke.py`` phase 5 does;
the masks go to build/model_masks/. Prints, per snapshot and root, the
IoU against the injected mask and the share of pixels flagged as the
first ROOT flags them, then one JSON line of those numbers. Imports
nothing of JAX.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "model_masks"


def load_chip_smoke():
    """This checkout's chip_smoke.py, whatever ROOT is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(root, index):
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    from rfi_toolbox_tpu_torch.io import flag_waterfalls
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor
    from rfi_toolbox_tpu_torch.utils import set_tf32

    smoke = load_chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("model_masks: no CUDA device")
    set_tf32(False)
    wf, mask = smoke.make_waterfalls(np.random.default_rng(smoke.SEED))
    wf = torch.from_numpy(wf).cuda()
    flags = {}
    for path in smoke.SNAPSHOTS:
        pred = CompiledPredictor.from_snapshot(str(REPO / path), batch_size=smoke.BATCH)
        flags[path] = flag_waterfalls(wf, method="model", predictor=pred).cpu()
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save({"flags": flags, "mask": torch.from_numpy(mask)}, OUT / f"{index}.pt")


def main(roots):
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for i, root in enumerate(roots):
        out = subprocess.run([sys.executable, __file__, "--worker", root, str(i)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"model_masks: run {i} ({root}) failed")
        runs.append(torch.load(OUT / f"{i}.pt"))
    summary = {}
    for path, first in runs[0]["flags"].items():
        summary[path] = []
        for root, run in zip(roots, runs):
            flags = run["flags"][path]
            mask = run["mask"]
            iou = float((flags & mask).sum() / (flags | mask).sum())
            agree = float((flags == first).float().mean())
            summary[path].append({"root": root, "iou": iou, "agree_with_first": agree})
            print(f"{path} {root}: IoU {iou:.6f}, pixels flagged as {roots[0]} flags "
                  f"them {agree:.6f}", flush=True)
    print(json.dumps({"card": smi, "roots": roots, "masks": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1:] or ["."]))
