"""BENCHMARK.json resolves to its files, keeps the contract's shape, and
takes a new mix and metric as new files and entries alone."""

import hashlib
import json
import re
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_workload_resolves_to_its_files():
    spec = harness.spec()
    for w in spec["workloads"]:
        cell = harness.resolve(w["name"], 1, "cpu", False)
        assert (harness.BENCH / "loops" / f"{cell.traffic['loop']}.py").is_file()
        assert cell.limits, w["name"]
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                assert (harness.BENCH / "end_to_end" / f"{m['name']}.py").is_file()
        for m in cell.per_layer:
            assert (harness.BENCH / "layer_metrics" / f"{m['name']}.py").is_file()
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_contract_shape():
    spec = harness.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    layers = {}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        # a per-layer metric's cells report the end-to-end metric it moves
        for c in m["workloads"]:
            assert c in cells and c in e2e[m["moves"]].get("workloads", [c])
        layers.setdefault(m["name"], m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == [] and "assumed" in conf
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


DUMMY_METRIC = '''"""Calls of the window (a dummy reader)."""


def read(ctx):
    return float(len(ctx.window.calls))
'''


def test_a_new_mix_and_metric_need_no_edit(tmp_path, tiny):
    """In a copy, a mix, a limits file and a metric are added as new files
    and entries; a run of the new cell reads the new metric, and no file
    that was there changes."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    mix = json.loads((bench / "traffic" / "static_prep_auto_8x1024.json").read_text())
    mix["waterfalls"]["stripes"]["count"] = 2
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "limits" / "dummy_cell.json").write_text(
        (bench / "limits" / "train_unet32_auto.json").read_text())
    (bench / "layer_metrics" / "dummy_calls.py").write_text(DUMMY_METRIC)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy_cell", "config": "unet32_bn_bf16_train",
                              "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "trainer",
                              "moves": "train_patches_per_s", "workloads": ["dummy_cell"]})
    spec["end_to_end"][0]["workloads"].append("dummy_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after_add = {p: hashlib.sha256(p.read_bytes()).hexdigest()
                 for p in before}
    assert after_add == before
    code = (f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "from benchmark import harness\n"
            f"r = harness.run_cell('dummy_cell', 3, 0.2, 1, device='cpu', "
            f"overrides={tiny['train_unet32_auto']!r})\n"
            "print(json.dumps(r['metrics']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["dummy_calls"]["value"] >= 1
