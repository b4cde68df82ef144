"""Runs one cell of ``BENCHMARK.json``, driven by data.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<mix>.json``); the mix names its loop
(``loops/<loop>.py``), the code that makes the calls of the window from
the mix's numbers. Each metric is read by a file of its own:
``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``, each with a
``read(ctx)`` that returns a number, or None where it finds nothing to
read. The limits of the comparison that decides ``correct`` are in
``limits/<workload>.json``. Adding a cell, a configuration, a mix or a
metric adds files and entries and edits none.

A run: set-up (the loop builds the program's objects and the inputs
from the seed, and warms up every shape of the window), the window, the
peak memory, then the program's state is freed and the loop's
``readings`` compare what the timed path produced with the reference.
A traced run whose every stretch was refused, or in which a per-layer
metric of the cell finds nothing to read, raises :class:`Refused`: its
result would lack numbers that the cell reports.
"""

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path

import torch

from benchmark.trace import Refused, Tracer

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device
    tracer: Tracer
    root: Path
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Context:
    """What a metric reader reads: the cell, the window, the trace of a
    ``--trace 1`` run (else None), and the loop's facts. ``steady`` is
    the window before the profiler started: host-clock readings of a
    traced run take it, so that the profiler's cost stays out of them."""

    cell: Cell
    window: object
    trace: object
    facts: dict

    @property
    def steady(self):
        return self.window.before(self.cell.tracer.started)


def load_module(path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _merge(base, over):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def resolve(name, seed, device, trace, overrides=None):
    """The :class:`Cell` of workload ``name``; ``overrides`` (tests) may
    replace numbers of its ``config``, ``traffic`` and ``limits``."""
    bench = spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    overrides = overrides or {}
    config = _merge(json.loads((ROOT / conf["file"]).read_text()), overrides.get("config"))
    traffic = _merge(json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
                     overrides.get("traffic"))
    limits = _merge(json.loads((BENCH / "limits" / f"{name}.json").read_text()),
                    overrides.get("limits"))
    covers = lambda m: name in m.get("workloads", [name])
    device = torch.device(device)
    # the profiler traces the card; on the CPU (tests) a traced run has no trace
    return Cell(name, config, traffic, limits, int(seed), device,
                Tracer(trace and device.type == "cuda", traffic.get("trace_seconds", 1.0)), ROOT,
                [m for m in bench["end_to_end"] if covers(m)],
                [m for m in bench["per_layer"] if covers(m)])


def loop_of(cell):
    return load_module(BENCH / "loops" / f"{cell.traffic['loop']}.py")


def check(cell, loop, evidence, control=False):
    """Each number compared, with its limit: [{"name", "value", "limit",
    "ok"}]. A number over its limit, or not a number, fails."""
    got = loop.readings(cell, evidence, control=control)
    out = []
    for name, limit in cell.limits.items():
        value = got.get(name)
        ok = value is not None and value == value and value <= limit
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return out


def run_cell(name, seed, seconds, trace, device="cuda", overrides=None, t_begin=None):
    """One run of cell ``name``: returns the result object (its keys in
    the contract's order, the comparison last)."""
    t_begin = time.perf_counter() if t_begin is None else t_begin
    cell = resolve(name, seed, device, bool(trace), overrides)
    module = loop_of(cell)
    run = module.Loop(cell)
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_begin
    window = run.run_window(seconds)
    peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0
    ctx = Context(cell, window, cell.tracer.trace, run.facts())
    metrics = {}
    if trace:
        if cell.tracer.enabled and ctx.trace is None:
            raise Refused("no traced stretch was recorded whole: "
                          + "; ".join(cell.tracer.refusals))
        for m in cell.per_layer:
            value = load_module(BENCH / "layer_metrics" / f"{m['name']}.py").read(ctx)
            if value is None:
                raise Refused(f"{m['name']} found nothing to read in the traced run")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = (setup_s if m["name"] == "setup_s" else
                     load_module(BENCH / "end_to_end" / f"{m['name']}.py").read(ctx))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": None, "attempted": len(window.calls), "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace and ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_us * 1e-6
        device_info["window_s"] = ctx.trace.window_us * 1e-6
        result["breakdown"] = ctx.trace.breakdown()
    evidence = run.release()
    del run, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check(cell, module, evidence)
    result["correct"] = all(c["ok"] for c in checks)
    result["failed"] = module.failed_answers(evidence, result["correct"])
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result
