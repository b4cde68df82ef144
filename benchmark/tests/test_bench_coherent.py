"""The coherent flagging cell (``flag_unet24gn_coherent``): it resolves
from ``BENCHMARK.json`` to its files; its reference
(``reference/coherent.py``, which the tests' ``tests/plain_coherent.py``
re-exports) agrees with the program; its readers, and the flag cells'
readers it shares, take what they should from a trace; on the CPU at a tiny size a
run is correct and the control and every fault fail the comparison (the
TF32 half of the control runs as float32 on the CPU and is held on the
card alone)."""

import json
import math
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, coherent_counts, counts, faults, harness
from benchmark.reference import coherent as ref
from benchmark.trace import Kernel, Span, Trace

ROOT = harness.ROOT
CELL = "flag_unet24gn_coherent"
# 2 baselines of 4 pols x 64 x 96: 2 x 2 x 3 = 12 images of 32², 3 forwards of 4
TINY = {"config": {"predictor_batch": 4, "patch_size": 32},
        "traffic": {"pool": 2, "waterfalls": {"count": 8, "channels": 64, "times": 96}}}


def _loop_module():
    return harness.loop_of(harness.resolve(CELL, 1, "cpu", False))


def _fails(got):
    cell = harness.resolve(CELL, 1, "cpu", False, TINY)
    return [n for n, limit in cell.limits.items() if not got[n] <= limit]


def test_the_cell_resolves_to_its_files():
    cell = harness.resolve(CELL, 1, "cpu", False)
    assert cell.traffic["loop"] == "flag_coherent"
    assert cell.config["model"]["norm"] == "group" and cell.config["model"]["in_channels"] == 8
    assert cell.config["threshold"] == 0.45 and cell.config["patch_size"] == 128
    assert set(cell.limits) == {"images_rel_gap", "logits_max_gap", "flags_differ"}
    assert {m["name"] for m in cell.end_to_end} == {"flag_mvis_per_s", "flag_call_p95_ms",
                                                   "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "coherent.images_device_ms", "coherent.images_roofline", "coherent.forward_device_ms",
        "flag_mfu", "predictor.device_ms", "device_idle_pct.flag", "flag.dispatch_ms"}
    spec = harness.spec()
    w = next(w for w in spec["workloads"] if w["name"] == CELL)
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    assert conf["reduced"] == [] and w["chips"] == 1
    meta = ref.load_snapshot(ROOT / cell.config["snapshot"])[1]
    assert meta["best_threshold"] == cell.config["threshold"]
    assert meta["init_features"] == cell.config["model"]["init_features"]
    assert meta["norm"] == "group" and meta["normalization"] == "robust_scale"


def test_the_counts_of_the_cell():
    f = counts.unet_forward_macs(128, 8, 24, 4) * 2
    assert round(coherent_counts.forward_flops(1, 128, 8, 24, 4) / 1e9, 3) == 3.436
    assert coherent_counts.forward_flops(1408, 128, 8, 24, 4) == 1408 * f
    n_bytes = coherent_counts.images_bytes(351 * 4 * 512 * 128, 1404, 128 * 128)
    assert round(n_bytes / 1e9, 3) == 1.472 and round(counts.bound_ms(n_bytes), 4) == 0.4395


# -- the reference -------------------------------------------------------------------------


def _vis4(seed=3, c=40, t=70):
    g = torch.Generator().manual_seed(seed)
    amp = 1 + 0.1 * torch.randn((2, 4, c, t), generator=g)
    amp[:, :, 5:7] += 1e6 * (1 + torch.rand((2, 4, 2, t), generator=g))
    return torch.polar(amp, 6.28 * torch.rand((2, 4, c, t), generator=g))


def test_the_reference_agrees_with_the_program():
    from rfi_toolbox_tpu_torch.io.flagging import coherent_images
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor

    path = ROOT / "pretrained/unet24gn_coherent8ch.npz"
    pred = CompiledPredictor.from_snapshot(path, batch_size=4, input_shape=(32, 32, 8),
                                           device="cpu")
    params, _ = ref.load_snapshot(path)
    state = pred.model.state_dict()
    assert set(state) == set(params)
    assert all(torch.equal(state[k], params[k]) for k in params)
    vis4 = _vis4()
    images = ref.coherent_images(vis4, 32)
    got = coherent_images(vis4, 32)
    assert ((got - images).abs() / images.abs().clamp_min(1)).max() <= 1e-6
    with torch.no_grad():
        want = ref.logits(params, images[:4], 4)
        z = pred.logits(images[:4])
    assert (z - want).abs().max() <= 1e-4 * max(1.0, float(want.abs().max()))


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark.reference import coherent\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "rfi_toolbox_tpu", "rfi_toolbox_tpu_torch",
                        "plain_coherent"}


# -- the readers ---------------------------------------------------------------------------


PROGRAM = ("coherent.call", "coherent.images", "predict.logits")


def _trace(program):
    """Two calls, each: the images' two kernels, then a forward of two
    kernels inside the predictor; the program's spans named in
    ``program`` (of :data:`PROGRAM`) around their kernels."""
    spans, kernels, corr = [], [], 0
    for call in range(2):
        t0 = call * 1000.0

        def k(name, us):
            nonlocal corr
            corr += 1
            kernels.append(Kernel(name, t0 + corr, t0 + corr + us, t0, corr))

        def mark():
            nonlocal corr
            corr += 1
            return corr

        def close(name, lo):
            if name in program:
                spans.append(Span(name, str(call), t0, t0 + 1, lo, mark()))

        lo = mark()
        c, a = mark(), mark()
        k("sort", 300.0)
        k("scale", 100.0)
        close("coherent.images", a)
        p, z = mark(), mark()
        k("conv", 2000.0)
        k("group_norm", 1000.0)
        close("predict.logits", z)
        spans.append(Span("predictor", "", t0, t0 + 1, p, mark()))
        close("coherent.call", c)
        spans.append(Span("flag_waterfalls_coherent", str(call), t0, t0 + 2, lo, mark()))
    return Trace(kernels, sorted(spans, key=lambda s: s.lo), 5000.0)


class _Ctx:
    def __init__(self, trace, facts):
        self.trace, self.facts = trace, facts


def _read(name, ctx):
    return harness.load_module(harness.BENCH / "layer_metrics" / f"{name}.py").read(ctx)


@pytest.mark.parametrize("program", [PROGRAM, (), PROGRAM[:1] + PROGRAM[2:]],
                         ids=["program", "before_the_spans", "images_span_renamed"])
def test_the_images_readers(program):
    """The program's ``coherent.images`` spans; a program from before the
    coherent spans (the fallback: the call outside the predictor); a
    program with ``coherent.call`` but no ``coherent.images``: nothing."""
    trace = _trace(program)
    calls, kernels = coherent_counts.images_kernels(trace)
    ctx = _Ctx(trace, {"images_bytes": 1e9})
    forward = _read("coherent.forward_device_ms", ctx)
    assert forward == (pytest.approx(3.0) if "predict.logits" in program else None)
    if "coherent.call" in program and "coherent.images" not in program:
        assert (calls, kernels) == (0, [])
        assert _read("coherent.images_device_ms", ctx) is None
        assert _read("coherent.images_roofline", ctx) is None
        return
    assert calls == 2 and sorted(k.name for k in kernels) == ["scale", "scale", "sort", "sort"]
    assert _read("coherent.images_device_ms", ctx) == pytest.approx(0.4)
    assert _read("coherent.images_roofline", ctx) == pytest.approx(
        100 * counts.bound_ms(1e9) / 0.4)


def test_the_shared_flag_readers_read_the_cell():
    """``predictor.device_ms`` and ``device_idle_pct.flag`` from the trace,
    ``flag.dispatch_ms`` and ``flag_mfu`` from the window before it and the
    loop's facts, as in the model cell."""
    from benchmark.window import Call, Window

    trace = _trace(PROGRAM)
    ctx = _Ctx(trace, {"flops_per_call": 1e12})
    ctx.steady = Window(0.0, 2.0, [Call(0.0, 0.1, 0.5, {}), Call(0.5, 0.7, 1.0, {})])
    assert _read("predictor.device_ms", ctx) == pytest.approx(3.0)
    idle = _read("device_idle_pct.flag", ctx)
    assert 0 < idle < 100 and idle == pytest.approx(100 * (1 - trace.busy_us / 5000))
    assert _read("flag.dispatch_ms", ctx) == pytest.approx(150.0)
    assert _read("flag_mfu", ctx) == pytest.approx(100 * 1e12 / counts.F32_ACCURATE_FLOPS_PER_S)


def test_the_program_marks_follow_the_named_spans():
    loop = _loop_module()
    edges = []

    class Tracer:
        def span(self, name, tag):
            class S:
                def __enter__(self):
                    edges.append(("open", name, tag))

                def __exit__(self, *exc):
                    edges.append(("close", name, tag))
            return S()

    marks = loop.ProgramMarks(Tracer(), loop.READ_SPANS)
    for name, tag in [("coherent.call", "1"), ("coherent.images", "1"), ("coherent.scale", "1"),
                      ("coherent.scale", "1"), ("coherent.images", "1"),
                      ("predict.logits", "1"), ("predict.logits", "1"),
                      ("predict.logits", "1"), ("predict.logits", "1"), ("coherent.call", "1")]:
        marks(name, tag)
    assert edges == [("open", "coherent.call", "1"), ("open", "coherent.images", "1"),
                     ("close", "coherent.images", "1")] + [
        ("open", "predict.logits", "1"), ("close", "predict.logits", "1")] * 2 + [
        ("close", "coherent.call", "1")]
    assert not marks.open


# -- whole runs at a tiny size ---------------------------------------------------------------


def test_a_tiny_run_is_correct():
    result = harness.run_cell(CELL, 2 ** 31 + 17, 0.3, 0, device="cpu", overrides=TINY)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
    assert set(result["metrics"]) == {"flag_mvis_per_s", "flag_call_p95_ms", "setup_s"}


def test_the_control_is_rejected():
    got = calibrate.readings(CELL, 5, 0.2, control=True, device="cpu", overrides=TINY)
    assert "images_rel_gap" in _fails(got)


def test_the_fault_is_rejected():
    with faults.altered_flags():
        result = harness.run_cell(CELL, 7, 0.2, 0, device="cpu", overrides=TINY)
    assert result["correct"] is False
    assert result["checks"]["flags_differ"]["value"] > result["checks"]["flags_differ"]["limit"]


def test_a_predictor_below_its_precision_fails_the_logits():
    """The logits catch a predictor that works below float32 (here on
    bf16-rounded inputs) though its images are exact."""
    from rfi_toolbox_tpu_torch import serving

    logits = serving.CompiledPredictor.logits

    def rounded(self, images):
        return logits(self, images.bfloat16().float())

    with faults._patched(serving.CompiledPredictor, "logits", rounded):
        result = harness.run_cell(CELL, 7, 0.2, 0, device="cpu", overrides=TINY)
    checks = result["checks"]
    assert checks["images_rel_gap"]["value"] <= checks["images_rel_gap"]["limit"]
    assert checks["logits_max_gap"]["value"] > checks["logits_max_gap"]["limit"], checks


@pytest.mark.card
def test_on_the_card_at_full_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = calibrate.readings(CELL, 13, 2.0)
    assert not _fails(got)
    got = calibrate.readings(CELL, 13, 2.0, control=True)
    assert {"images_rel_gap", "logits_max_gap"} <= set(_fails(got))
    assert math.isfinite(got["logits_max_gap"])
