"""Port parity: the raw-patch training path (``DevicePreprocessor``,
``augment_batch``, ``make_raw_patch_step``, ``RawPatchTrainer``) against
the JAX package, on the CPU in float32.

Tolerances: the kept patches, masks and indices are bit-equal (the same
numpy rng); a raw-patch step on the JAX-augmented batch (the JAX draw is
passed across: ``torch.Generator`` cannot reproduce ``jax.random``) is
held to ``test_torch_train.py::test_train_steps_match_jax``'s bounds
(loss 1e-5 relative; parameters 2 * lr, updates 1e-3 * lr on 99.5% of
the coordinates with a gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.preprocess import DevicePreprocessor as JaxDevicePreprocessor
from rfi_toolbox_tpu.train import raw_patches as jax_raw
from rfi_toolbox_tpu.train import train_step as jax_train_step
from rfi_toolbox_tpu_torch import ops
from rfi_toolbox_tpu_torch.models import UNet
from rfi_toolbox_tpu_torch.preprocess import DevicePreprocessor, GPUPreprocessor
from rfi_toolbox_tpu_torch.train import RawPatchTrainer, augment_batch, train_step
from rfi_toolbox_tpu_torch.train import raw_patches
from rfi_toolbox_tpu_torch.train.raw_patches import make_raw_patch_step
from test_torch_train import HW, _assert_params_close, _jax_state, _port_state, _start


def _waterfalls(rng, b, p, h, w, blank=()):
    """Complex waterfalls and flags with RFI stripes; the waterfalls in
    ``blank`` have no flag and hold zeros in their first rows."""
    amp = rng.lognormal(0, 1, (b, p, h, w))
    flags = np.zeros((b, p, h, w), bool)
    for i in range(b):
        if i in blank:
            amp[i, :, : h // 2] = 0
            continue
        c = rng.integers(0, h - 3)
        flags[i, :, c:c + 3] = True
        amp[i, :, c:c + 3] += 100
    vis = (amp * np.exp(1j * rng.uniform(0, 2 * np.pi, amp.shape))).astype(np.complex64)
    return vis, flags


@pytest.mark.parametrize("case", [
    dict(patch_size=16, seed=3),                     # padded, flags given
    dict(patch_size=16, seed=4, flags=False),        # |data| > 0 as the mask
    dict(patch_size=16, seed=5, num_patches=5),      # the reference's rng.choice cut
    dict(patch_size=16, seed=6, remove_blank=False),
    dict(patch_size=64, seed=7),                     # one patch a waterfall
])
def test_create_raw_patches_matches_jax(case):
    rng = np.random.default_rng(0)
    vis, flags = _waterfalls(rng, 3, 2, 40, 48, blank=(1,))
    case = dict(case)
    given = flags if case.pop("flags", True) else None
    want = JaxDevicePreprocessor(vis, given)
    jp, jm = want.create_raw_patches(**case)
    got = DevicePreprocessor(vis, given, device="cpu")
    pp, pm = got.create_raw_patches(**case)
    assert pp.dtype == torch.complex64 and pm.dtype == torch.bool
    np.testing.assert_array_equal(pp.numpy(), jp)
    np.testing.assert_array_equal(pm.numpy(), jm)
    assert got.original_shapes == want.original_shapes
    assert got.estimate_storage_mb() == got._estimate_storage_mb() == want.estimate_storage_mb()
    assert len(pp) > 0


def test_device_preprocessor_refuses_real_data():
    with pytest.raises(ValueError, match="requires complex data"):
        DevicePreprocessor(np.ones((2, 8, 8), np.float32), device="cpu")
    assert GPUPreprocessor is DevicePreprocessor
    assert DevicePreprocessor(np.ones((2, 8, 8), np.complex64),
                              device="cpu").estimate_storage_mb() == 0.0


def test_augment_batch_draws_group_members_with_their_masks():
    rng = np.random.default_rng(1)
    n, p = 64, 8
    patches = torch.from_numpy((rng.normal(size=(n, p, p))
                                + 1j * rng.normal(size=(n, p, p))).astype(np.complex64))
    masks = torch.from_numpy(rng.random((n, p, p)) < 0.5)
    out, out_masks = augment_batch(torch.Generator().manual_seed(0), patches, masks)
    group = [lambda a: a, lambda a: a.flip(0), lambda a: a.T, lambda a: a.T.flip(0)]
    drawn = []
    for i in range(n):
        hits = [v for v, t in enumerate(group) if torch.equal(out[i], t(patches[i]))]
        assert len(hits) == 1, f"sample {i} is not one member of the group"
        assert torch.equal(out_masks[i], group[hits[0]](masks[i]))
        drawn.append(hits[0])
    assert sorted(set(drawn)) == [0, 1, 2, 3]


def test_raw_patch_step_matches_jax(monkeypatch):
    """One JAX raw-patch step (jnp extraction on the CPU) and the port's,
    fed the batch that JAX's augmentation drew for the same key."""
    rng = np.random.default_rng(2)
    patches = (rng.lognormal(0, 1, (4, HW, HW))
               * np.exp(1j * rng.uniform(0, 2 * np.pi, (4, HW, HW)))).astype(np.complex64)
    patches[:, 5:8] *= 100
    masks = np.zeros((4, HW, HW), bool)
    masks[:, 5:8] = True
    key = jax.random.key(5)
    aug_p, aug_m = jax_raw.augment_batch(key, jnp.asarray(patches), jnp.asarray(masks))
    jstate = _jax_state("batch")
    pstate = _port_state(jstate, "batch")
    start = _start(pstate)
    jstate, jloss = jax_raw.make_raw_patch_step(jax_train_step)(
        jstate, key, jnp.asarray(patches), jnp.asarray(masks))
    monkeypatch.setattr(raw_patches, "augment_batch", lambda g, p, m: (
        torch.from_numpy(np.array(aug_p)), torch.from_numpy(np.array(aug_m))))
    pstate, ploss = make_raw_patch_step(train_step)(
        pstate, None, torch.from_numpy(patches), torch.from_numpy(masks))
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_params_close(pstate, jstate, "batch", 1, start)


def test_raw_patch_trainer_fits_on_the_cpu():
    rng = np.random.default_rng(3)
    vis, flags = _waterfalls(rng, 2, 1, 32, 32)
    raw, masks = DevicePreprocessor(vis, flags, device="cpu").create_raw_patches(
        patch_size=16, seed=0)
    before = ops.fused_extract_channels.launches
    trainer = RawPatchTrainer(UNet(init_features=2, depth=2), seed=1, device="cpu")
    result = trainer.fit(raw, masks, num_epochs=2, batch_size=2)
    history = result["history"]
    assert [h["epoch"] for h in history] == [1, 2]
    assert all(np.isfinite(h["train_loss"]) for h in history)
    assert trainer.state.step == 2 * max(len(raw) // 2, 1)
    assert ops.fused_extract_channels.launches == before  # the plain version on the CPU


def test_raw_patch_entry_points_want_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    vis = np.ones((1, 16, 16), np.complex64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePreprocessor(vis).create_raw_patches(patch_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RawPatchTrainer(UNet(init_features=2, depth=2))
