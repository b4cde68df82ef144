"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: rfi_toolbox_tpu_torch begins with rfi_toolbox_tpu."""

import json
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "rfi_toolbox_tpu"}


def _top_levels(code):
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = _top_levels(
        "import importlib.util, pathlib\n"
        "from benchmark import harness, calibrate, faults\n"
        "import rfi_toolbox_tpu_torch.io.flagging, rfi_toolbox_tpu_torch.train\n"
        "for d in ('loops', 'end_to_end', 'layer_metrics'):\n"
        "    for p in sorted((harness.BENCH / d).glob('*.py')):\n"
        "        harness.load_module(p)\n")
    assert not names & FORBIDDEN
    assert "rfi_toolbox_tpu_torch" in names


def test_the_reference_loads_nothing_of_the_program():
    names = _top_levels("from benchmark.reference import extract, mad, precision, prep, unet")
    assert not names & (FORBIDDEN | {"rfi_toolbox_tpu_torch"})


def test_no_result_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "flag_mad_vla_block", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and "{" not in out.stdout
