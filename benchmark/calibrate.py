#!/usr/bin/env python3
"""The readings that the limits of ``limits/<workload>.json`` are set
from, on the card at the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 [--seconds S]
        [--control] [--fault NAME]

For each seed it builds the cell as a run does, drives a short window of
``S`` seconds (training's readings need none) and prints one JSON line:
the numbers compared, of the program (the lower readings), of the
control (``--control``: the reference in the next precision below the
configuration's, put in the program's place; the upper readings), or of
the program with a fault planted under the timed path (``--fault``, from
``benchmark/faults.py``). The benchmark's own runs never run this.
"""

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(name, seed, seconds, control=False, fault=None, device="cuda", overrides=None):
    """The numbers compared for one seed: {name: value}."""
    import torch

    from benchmark import faults, harness

    cell = harness.resolve(name, seed, device, False, overrides)
    module = harness.loop_of(cell)
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        run = module.Loop(cell)
        run.run_window(seconds)
        evidence = run.release()
    del run
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return module.readings(cell, evidence, control=control)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(args.workload, seed, args.seconds, args.control, args.fault)
        kind = "control" if args.control else (f"fault {args.fault}" if args.fault else "program")
        print(json.dumps({"workload": args.workload, "seed": seed, "of": kind, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
