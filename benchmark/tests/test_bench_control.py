"""The comparison rejects the control (the reference in the next
precision below the configuration's, put in the program's place) and
every fault each cell can have, planted under the timed path; on the
CPU at a tiny size here, and on the card at the cell's own size."""

import pytest
import torch

from benchmark import calibrate, faults, harness

WORKLOADS = ["train_unet32_auto", "flag_unet16_model_8x1024", "flag_mad_vla_block"]
CASES = [(w, f) for w in WORKLOADS
         for f in faults.BY_LOOP[harness.resolve(w, 1, "cpu", False).traffic["loop"]]]


def _fails(workload, got, overrides=None):
    cell = harness.resolve(workload, 1, "cpu", False, overrides)
    return [n for n, limit in cell.limits.items() if not got[n] <= limit]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_rejected(workload, tiny):
    got = calibrate.readings(workload, 5, 0.2, control=True, device="cpu",
                             overrides=tiny[workload])
    assert _fails(workload, got, tiny[workload])


@pytest.mark.parametrize("workload, fault", CASES)
def test_each_fault_is_rejected(workload, fault, tiny):
    with faults.FAULTS[fault]():
        result = harness.run_cell(workload, 7, 0.2, 0, device="cpu", overrides=tiny[workload])
    assert result["correct"] is False, (fault, result["checks"])


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_on_the_card_at_full_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = calibrate.readings(workload, 13, 2.0)
    assert not _fails(workload, got)
    got = calibrate.readings(workload, 13, 2.0, control=True)
    assert _fails(workload, got)


def test_a_predictor_below_its_precision_fails_the_logits(tiny):
    """The model cell's logits catch a predictor that works below float32
    (here on bf16-rounded inputs) though its images are exact."""
    from rfi_toolbox_tpu_torch import serving

    logits = serving.CompiledPredictor.logits

    def rounded(self, images):
        return logits(self, images.bfloat16().float())

    workload = "flag_unet16_model_8x1024"
    with faults._patched(serving.CompiledPredictor, "logits", rounded):
        result = harness.run_cell(workload, 7, 0.2, 0, device="cpu", overrides=tiny[workload])
    checks = result["checks"]
    assert checks["images_max_abs"]["value"] <= checks["images_max_abs"]["limit"]
    assert checks["logits_max_gap"]["value"] > checks["logits_max_gap"]["limit"], checks
