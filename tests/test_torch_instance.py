"""Port parity: the SOLOLite instance model (forward, targets, loss,
Matrix-NMS, decode, matching) against the JAX package, on the CPU.

Inputs are numpy arrays made from fixed seeds, or JAX's own instance
batches, handed to both packages. Tolerances:

- ``jax.image.resize``'s weights within an ulp of 1 (a row's sum in
  another order; bit-equal at the model's ratios), a resize within 1e-6
  of the output's max |value| (the two products' order);
- forward outputs within 1e-4 of JAX's, relative to each output's max
  |value| (random initialisation at features 8, grid 4, 32²; the s2d
  stem; the shipped snapshot on 2 images of 128²);
- ``assign_targets`` bit-equal (integer-valued sums in float32);
- ``solo_loss``: total, ``cate_loss`` and ``mask_loss`` within 1e-5
  relative, ``dropped_mask_cells`` equal;
- ``matrix_nms``/``solo_decode``: decayed scores within 1e-6, classes and
  masks equal;
- ``match_instances`` equal to JAX's;
- the shipped snapshot through both packages' predict -> match on JAX's
  held-out batch (seed 10 000, 8 images): ``tp``, ``n_gt`` and ``n_det``
  equal; and the port on tests/test_instance_quality.py's own held-out
  sets (JAX's stream, 16 and 64 images) meets that file's floors.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from rfi_toolbox_tpu.evaluation import match_instances as jax_match
from rfi_toolbox_tpu.models import instance as JI
from rfi_toolbox_tpu.preprocess import pipeline as JP
from rfi_toolbox_tpu.synth.sample import make_instance_sample_generator as jax_generator
from rfi_toolbox_tpu.train import InstanceTrainer as JaxInstanceTrainer
from rfi_toolbox_tpu.train import load_params as jax_load_params
from rfi_toolbox_tpu_torch.evaluation import match_instances
from rfi_toolbox_tpu_torch.models import (
    SOLOLite,
    assign_targets,
    matrix_nms,
    solo_decode,
    solo_loss,
    sololite_from_flax,
    sololite_from_snapshot,
    sololite_to_flax,
)
from rfi_toolbox_tpu_torch.models.instance import _resize_weights, resize
from rfi_toolbox_tpu_torch.train import InstanceTrainer

WEIGHTS = Path(__file__).resolve().parents[1] / "pretrained" / "sololite_synthetic.npz"
SIZE, GRID, FEATURES, EMBED = 32, 4, 8, 16
ALL_SIX = {
    "narrowband_persistent": {"count": [1, 3]},
    "broadband_persistent": {"count": [0, 2]},
    "narrowband_intermittent": {"count": [0, 2]},
    "narrowband_bursty": {"count": [0, 2]},
    "broadband_bursty": {"count": [0, 1]},
    "frequency_sweep": {"count": [0, 1]},
}
TARGETS = ("inst_masks", "inst_classes", "inst_valid")


@functools.cache
def _jax_batch(n=4, size=SIZE, mix="all6", seed=0):
    """A batch of JAX's instance generator as numpy arrays, with its
    ImageNet-normalised images."""
    gen = jax_generator(size, size, rfi_config=ALL_SIX if mix == "all6" else None)
    batch = jax.jit(jax.vmap(gen))(random.split(random.key(seed), n))
    batch = {k: np.array(v) for k, v in batch.items()}
    batch["images"] = np.array(JP.imagenet_normalize(JP.extract_channels(
        jnp.asarray(batch["waterfall"]))))
    return batch


@functools.cache
def _jax_model(s2d=False, seed=1):
    """A JAX SOLOLite at small width, its parameters and its outputs on
    ``_jax_batch()``, and the port's model with the same weights."""
    model = JI.SOLOLite(num_classes=6, grid_size=GRID, embed_dim=EMBED, features=FEATURES,
                        space_to_depth=s2d)
    images = jnp.asarray(_jax_batch()["images"])
    params = jax.jit(model.init)(random.key(seed), images)["params"]
    out = jax.jit(model.apply)({"params": params}, images)
    port = SOLOLite(6, GRID, EMBED, FEATURES, space_to_depth=s2d)
    port.load_state_dict(sololite_from_flax(jax.device_get(params), port))
    return model, params, {k: np.array(v) for k, v in out.items()}, port


def _t(batch, keys=TARGETS):
    return [torch.from_numpy(batch[k]) for k in keys]


def _assert_outputs_close(got, want, rtol=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        assert g.shape == w.shape, k
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= rtol, f"{k}: {err:.2e} of max |value|"


@pytest.mark.parametrize("n_in, n_out", [(32, 8), (128, 64), (32, 64), (32, 128), (8, 32),
                                         (7, 3), (16, 16)])
def test_resize_matches_jax(n_in, n_out):
    """The grid head's and the ground truth's antialiased downsamples, and
    the upsamples of the loss and the decode."""
    eye = jnp.eye(n_in, dtype=jnp.float32)
    want = np.asarray(jax.image.resize(eye, (n_out, n_in), method="linear"))
    np.testing.assert_allclose(_resize_weights(n_in, n_out, torch.device("cpu")).numpy(),
                               want, rtol=0, atol=6e-8)
    x = np.random.default_rng(n_in * n_out).normal(size=(2, 3, n_in, n_in)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, n_out, n_out), method="bilinear"))
    got = resize(torch.from_numpy(x), (n_out, n_out)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
def test_forward_matches_jax(s2d):
    _, params, want, port = _jax_model(s2d)
    got = port(torch.from_numpy(_jax_batch()["images"]))
    _assert_outputs_close(got, want)
    assert got["cate_logits"].shape == (4, GRID, GRID, 6)
    assert got["mask_feats"].shape == (4, SIZE // 4, SIZE // 4, EMBED)
    # Flax's names and shapes, both ways, bit-equal
    back = sololite_to_flax(port)
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    mine = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(mine)
    for path, v in flat:
        np.testing.assert_array_equal(mine[path], np.asarray(v))


def _jax_trainer(batch_size, rfi_config=None):
    """JAX's ``InstanceTrainer.load`` of the shipped snapshot, without its
    eager initialisation."""
    params, _, meta = jax_load_params(WEIGHTS)
    model = JI.SOLOLite(num_classes=meta["num_classes"], grid_size=meta["grid_size"],
                        embed_dim=meta["embed_dim"], features=meta["features"])
    jtr = JaxInstanceTrainer(model=model, patch_size=meta["patch_size"], batch_size=batch_size,
                             seed=0, rfi_config=rfi_config)
    jtr.params = params
    return jtr


def _held_out(jtr, num_images):
    """JAX's held-out batches at seed 10 000, drawn as its
    ``evaluate_instance_model`` draws them, as numpy arrays with their
    images."""
    key, batches = random.key(10_000), []
    for _ in range(num_images // jtr.batch_size):
        key, k = random.split(key)
        batch = {n: np.array(v) for n, v in jtr._batch_fn(random.split(k, jtr.batch_size)).items()}
        batch["images"] = np.array(JP.imagenet_normalize(JP.extract_channels(
            jnp.asarray(batch["waterfall"]))))
        batches.append(batch)
    return batches


@functools.cache
def _shipped():
    """The JAX trainer on the shipped snapshot and JAX's first held-out
    batch at seed 10 000 (8 images of 128², the default mix)."""
    jtr = _jax_trainer(8)
    return jtr, _held_out(jtr, 8)[0]


def test_shipped_snapshot_forward_matches_jax():
    jtr, batch = _shipped()
    images = batch["images"][:2]
    want = jax.jit(jtr.model.apply)({"params": jtr.params}, jnp.asarray(images))
    model, meta = sololite_from_snapshot(WEIGHTS)
    assert (meta["features"], meta["embed_dim"], meta["grid_size"]) == (48, 48, 8)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    _assert_outputs_close(got, {k: np.asarray(v) for k, v in want.items()})


def test_held_out_matches_jax_on_the_shipped_snapshot():
    """Predict -> match on JAX's seed-10 000 batch through both packages."""
    jtr, batch = _shipped()
    jdets = jtr.predict(batch["images"], score_thresh=0.3)
    tr = InstanceTrainer.load(WEIGHTS, batch_size=8, device="cpu")
    dets = tr.predict(batch["images"], score_thresh=0.3)
    totals = np.zeros(3, int)
    for i in range(8):
        args = (batch["inst_masks"][i], batch["inst_classes"][i], batch["inst_valid"][i])
        want = jax_match(jdets[i], *args, score_thresh=0.3)
        got = match_instances(dets[i], *args, score_thresh=0.3)
        assert (got["tp"], got["n_gt"], got["n_det"]) == (want["tp"], want["n_gt"],
                                                          want["n_det"]), i
        totals += (got["tp"], got["n_gt"], got["n_det"])
    assert totals[1] > 10 and totals[0] >= 0.7 * totals[1]  # a real held-out set


@pytest.mark.parametrize("mix", ["all6", "default"])
def test_assign_targets_bit_equal(mix):
    batch = _jax_batch(mix=mix)
    for grid in (GRID, 8):
        want = JI.assign_targets(*(jnp.asarray(batch[k]) for k in TARGETS), grid, 6)
        got = assign_targets(*_t(batch), grid, 6)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_assign_targets_jax_cases():
    """tests/test_instance.py's centre-region and smallest-wins cases."""
    inst = np.zeros((1, 2, 64, 64), np.float32)
    inst[0, 0, 8:24, 8:24] = 1.0
    cate, idx = assign_targets(torch.from_numpy(inst), torch.tensor([[3, 0]]),
                               torch.tensor([[True, False]]), 8, 6)
    assert cate[0, 1, 1] == 3 and idx[0, 1, 1] == 0
    assert cate[0, 7, 7] == 6 and idx[0, 7, 7] == -1
    assert bool((idx != 1).all())
    inst = np.zeros((1, 2, 64, 64), np.float32)
    inst[0, 0] = 1.0
    inst[0, 1, 28:36, 28:36] = 1.0
    _, idx = assign_targets(torch.from_numpy(inst), torch.tensor([[0, 1]]),
                            torch.tensor([[True, True]]), 8, 6)
    assert idx[0, 3, 3] == 1


@pytest.mark.parametrize("cap", [2, None], ids=["cap2", "nocap"])
def test_solo_loss_matches_jax(cap):
    batch = _jax_batch()
    _, _, out, _ = _jax_model()
    loss = jax.jit(JI.solo_loss, static_argnames="max_positive_cells")
    total, parts = loss({k: jnp.asarray(v) for k, v in out.items()},
                        *(jnp.asarray(batch[k]) for k in TARGETS), max_positive_cells=cap)
    got_total, got = solo_loss({k: torch.from_numpy(v) for k, v in out.items()}, *_t(batch),
                               max_positive_cells=cap)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-5)
    for k in ("cate_loss", "mask_loss"):
        np.testing.assert_allclose(float(got[k]), float(parts[k]), rtol=1e-5, err_msg=k)
    assert int(got["dropped_mask_cells"]) == int(parts["dropped_mask_cells"])
    assert (int(got["dropped_mask_cells"]) > 0) == (cap is not None)


def _nms_case(rng, k=24, hw=16):
    """Random masks with duplicate clusters: copies of a few base masks
    with a few pixels flipped, shuffled, in 3 classes."""
    base = rng.random((6, hw, hw)) < 0.3
    masks = base[rng.integers(0, 6, k)] ^ (rng.random((k, hw, hw)) < 0.05)
    scores = rng.random(k).astype(np.float32)
    classes = rng.integers(0, 3, k)
    return masks, scores, classes


def test_matrix_nms_matches_jax():
    rng = np.random.default_rng(4)
    cases = [_nms_case(rng) for _ in range(3)]
    # tests/test_instance.py: a duplicate, and a duplicate cluster
    m = np.zeros((4, 16, 16), bool)
    m[:3, :8] = True
    m[3, 8:] = True
    cases.append((m, np.array([0.9, 0.8, 0.7, 0.6], np.float32), np.zeros(4, int)))
    for masks, scores, classes in cases:
        want = np.asarray(JI.matrix_nms(jnp.asarray(masks), jnp.asarray(scores),
                                        jnp.asarray(classes)))
        got = matrix_nms(torch.from_numpy(masks), torch.from_numpy(scores),
                         torch.from_numpy(classes)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # batched: each image's own
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*cases[:3])]
    got = matrix_nms(*stacked).numpy()
    for i, (masks, scores, classes) in enumerate(cases[:3]):
        want = np.asarray(JI.matrix_nms(jnp.asarray(masks), jnp.asarray(scores),
                                        jnp.asarray(classes)))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)
    decayed = matrix_nms(*(torch.from_numpy(np.asarray(a)) for a in cases[-1]))
    assert abs(float(decayed[0]) - 0.9) < 1e-6 and float(decayed[1]) < 0.2
    assert float(decayed[2]) < 0.2 and abs(float(decayed[3]) - 0.6) < 1e-6


@pytest.mark.parametrize("out_size", [None, (SIZE, SIZE)], ids=["quarter", "full"])
@pytest.mark.parametrize("active", ["all", "half"])
def test_solo_decode_matches_jax(out_size, active):
    _, _, out, _ = _jax_model()
    # every candidate active, or the upper half of the scores
    scores = 1 / (1 + np.exp(-out["cate_logits"].max(axis=-1)))
    thresh = 0.0 if active == "all" else float(np.median(scores))
    got = solo_decode({k: torch.from_numpy(v) for k, v in out.items()}, score_thresh=thresh,
                      out_size=out_size)
    assert got["masks"].shape[:2] == (4, GRID * GRID)
    for i in range(4):
        want = JI.solo_decode({k: jnp.asarray(v[i]) for k, v in out.items()},
                              score_thresh=thresh, out_size=out_size)
        np.testing.assert_array_equal(got["classes"][i].numpy(), np.asarray(want["classes"]))
        np.testing.assert_array_equal(got["masks"][i].numpy(), np.asarray(want["masks"]))
        np.testing.assert_allclose(got["scores"][i].numpy(), np.asarray(want["scores"]),
                                   rtol=0, atol=1e-6)


def _strip(h, w, sl):
    m = np.zeros((h, w), bool)
    m[sl] = True
    return m


def _det(masks, scores, classes):
    return {"masks": np.asarray(masks, bool), "scores": np.asarray(scores, float),
            "classes": np.asarray(classes, int)}


def _match_cases():
    """tests/test_instance_quality.py's cases, as (detections, gt, classes, kwargs)."""
    gt2 = np.stack([_strip(32, 32, np.s_[4:8, :]), _strip(32, 32, np.s_[:, 20:24])])
    gt1 = gt2[:1]
    good = _strip(32, 32, np.s_[4:8, :])
    half_gt = np.stack([_strip(32, 32, np.s_[0:8, :])])
    half = _det([_strip(32, 32, np.s_[0:4, :])], [0.9], [0])
    padded = np.stack([_strip(16, 16, np.s_[2:4, :]), np.zeros((16, 16), bool)])
    return [
        (_det(gt2, [0.9, 0.8], [2, 5]), gt2, [2, 5], {}),
        (_det(gt1, [0.9], [3]), gt1, [2], {}),
        (_det(gt1, [0.9], [3]), gt1, [2], {"require_class": False}),
        (_det([good, good], [0.9, 0.4], [1, 1]), gt1, [1], {"score_thresh": 0.3}),
        (_det([good, good], [0.9, 0.4], [1, 1]), gt1, [1], {"score_thresh": 0.5}),
        (_det([good, good], [0.9, 0.4], [1, 1]), gt1, [1], {"score_thresh": [0.5, 0.3]}),
        (half, half_gt, [0], {"iou_thresh": 0.5}),
        (half, half_gt, [0], {"iou_thresh": 0.6}),
        (_det([padded[0]], [0.9], [0]), padded, [0, 0],
         {"gt_valid": np.array([True, False])}),
        (_det(np.zeros((0, 32, 32)), [], []), gt2, [2, 5], {}),
        (_det(gt2, [0.9, 0.8], [2, 5]), np.zeros((2, 32, 32), bool), [0, 0], {}),
    ]


@pytest.mark.parametrize("case", range(len(_match_cases())))
def test_match_instances_matches_jax(case):
    det, gt, classes, kwargs = _match_cases()[case]
    want = jax_match(det, gt, np.array(classes), **kwargs)
    got = match_instances(det, gt, np.array(classes), **kwargs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("gate", ["default", "all six"])
def test_jax_quality_gates_hold_on_jax_held_out_set(gate):
    """tests/test_instance_quality.py's two gates, their floors, images and
    batches (JAX's stream at seed 10 000), on the port's predict and
    matching: default mix, 16 images at score 0.3: recall >= 0.7, n_gt >
    40; all six families, 64 images at 0.25: recall and precision >=
    0.80, each family present and >= 0.70, n_gt > 300."""
    cfg, batch_size, num_images, score = {
        "default": (None, 8, 16, 0.3), "all six": (ALL_SIX, 16, 64, 0.25)}[gate]
    tr = InstanceTrainer.load(WEIGHTS, batch_size=batch_size, device="cpu")
    tp = n_gt = n_det = 0
    fam_tp, fam_n = {}, {}
    for batch in _held_out(_jax_trainer(batch_size, cfg), num_images):
        dets = tr.predict(batch["images"], score_thresh=score)
        for i, det in enumerate(dets):
            valid = batch["inst_valid"][i]
            r = match_instances(det, batch["inst_masks"][i], batch["inst_classes"][i], valid,
                                score_thresh=score)
            tp, n_gt, n_det = tp + r["tp"], n_gt + r["n_gt"], n_det + r["n_det"]
            for c, m in zip(batch["inst_classes"][i][valid], r["matched"][valid]):
                fam_n[int(c)] = fam_n.get(int(c), 0) + 1
                fam_tp[int(c)] = fam_tp.get(int(c), 0) + int(m)
    recall, precision = tp / n_gt, tp / n_det
    per_family = {c: fam_tp[c] / fam_n[c] for c in fam_n}
    if gate == "default":
        assert n_gt > 40 and recall >= 0.7, (recall, n_gt)
    else:
        assert n_gt > 300 and recall >= 0.80 and precision >= 0.80, (recall, precision, n_gt)
        assert len(per_family) == 6 and min(per_family.values()) >= 0.70, per_family
