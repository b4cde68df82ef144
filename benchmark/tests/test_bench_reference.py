"""At a tiny size on the CPU, the reference agrees with the program's
path, and a whole run of each cell comes out correct."""

import pytest
import torch

from benchmark import harness, waterfalls
from benchmark.reference import extract, mad, prep, unet

SPEC = {"count": 2, "channels": 128, "times": 128, "noise": 0.1, "rfi": [1e6, 1e7],
        "stripes": {"count": 3, "width": [1, 4]}, "bursts": {"count": 2, "width": [1, 6]},
        "blocks": {"count": 2, "size": [8, 64]}}


def _block(seed=5):
    return waterfalls.make_pool(SPEC, 1, seed, "cpu")[0]


def test_the_generator_is_the_seeds():
    a, b = _block(7), _block(7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    wf, mask = a
    assert wf.dtype == torch.complex64 and mask.any() and not mask.all()
    amp = wf.abs()
    assert amp[mask].min() > 1e5 and amp[~mask].max() < 2


def test_static_prep_matches_the_program():
    from rfi_toolbox_tpu_torch.preprocess import Preprocessor

    wf, mask = _block()
    pre = Preprocessor(wf, flags=mask, device="cpu")
    ds = pre.create_dataset(patch_size=32, use_custom_flags=True, seed=0,
                            static_num_patches=96)
    images, labels, keep = prep.static_prep(wf, mask, 32, 96, 0)
    assert torch.equal(keep, pre.keep) and torch.equal(labels, ds.labels)
    assert (images - ds.images).abs().max() < 2e-5


def test_mad_matches_the_program():
    from rfi_toolbox_tpu_torch.io.flagging import flag_waterfalls

    wf, _ = _block()
    got = flag_waterfalls(wf, method="mad", sigma=5.0, patch_size=32, device="cpu")
    assert torch.equal(got, mad.waterfall_flags(wf, 5.0, 32))


def test_the_snapshot_forward_matches_the_program():
    from rfi_toolbox_tpu_torch.serving import CompiledPredictor

    wf, _ = _block()
    images = extract.images(extract.patchify(wf, 64))
    pred = CompiledPredictor.from_snapshot(harness.ROOT / "pretrained/unet16_synthetic.npz",
                                           device="cpu", batch_size=4)
    params, stats, _ = unet.load_snapshot(harness.ROOT / "pretrained/unet16_synthetic.npz")
    with torch.no_grad():
        ref = unet.forward(params, images.permute(0, 3, 1, 2), 4, stats)
        got = pred.logits(images)
    assert (ref - got).abs().max() < 1e-3 * ref.abs().max()


def test_train_steps_match_the_program_in_float32():
    from rfi_toolbox_tpu_torch.models import UNet
    from rfi_toolbox_tpu_torch.train import create_train_state, train_steps

    shapes = unet.param_shapes(4)
    w0 = unet.init_params(shapes, torch.Generator().manual_seed(3), "cpu")
    model = UNet(init_features=4, norm="batch")
    model.load_state_dict(w0, strict=False)
    state = create_train_state(model, seed=None, device="cpu")
    wf, mask = _block()
    images, labels, _ = prep.static_prep(wf, mask, 32, 64, 0)
    losses = train_steps(state, images.reshape(2, 32, 32, 32, 3),
                         labels.reshape(2, 32, 32, 32))[1]
    ref, _, params = unet.train_steps(w0, images, labels, 2, 32)
    assert torch.allclose(losses, torch.tensor(ref), rtol=1e-5)
    for name, p in state.model.named_parameters():
        # Adam moves each weight by about the learning rate whatever its
        # gradient; weights whose gradient is near 0 move by round-off
        moved = (params[name] - w0[name]).norm()
        assert (p.detach() - params[name]).norm() <= 2e-2 * moved + 1e-7, name


@pytest.mark.parametrize("workload", ["train_unet32_auto", "flag_unet16_model_8x1024",
                                      "flag_mad_vla_block"])
def test_a_tiny_run_is_correct(workload, tiny):
    result = harness.run_cell(workload, 2 ** 31 + 11, 0.3, 0, device="cpu",
                              overrides=tiny[workload])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
