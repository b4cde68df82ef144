"""Port parity: the UNet variants and create_model, the .npz snapshots of
export_params/load_params, the dataset files, evaluate_segmentation_batch
and Trainer (fit on in-memory datasets and on streamed batch
directories, checkpoints, predict) against the JAX package, on the CPU
in float32.

Tolerances: logits 1e-4 (different conv summation order, as
test_torch_models.py); snapshots bit-equal both ways; batch order equal;
fit's losses 1e-4 relative (the float32 train steps agree to 4e-7,
test_torch_train.py); predict's masks on all but 0.1% of the pixels
(a pixel at the 0.5 threshold may fall either way).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.data import ArrayDataset as JaxArrayDataset
from rfi_toolbox_tpu.data import BatchWriter as JaxBatchWriter
from rfi_toolbox_tpu.data import StreamingDataset as JaxStreamingDataset
from rfi_toolbox_tpu.evaluation import evaluate_segmentation_batch as jax_eval_batch
from rfi_toolbox_tpu.models import UNet as FlaxUNet
from rfi_toolbox_tpu.models import create_model as jax_create_model
from rfi_toolbox_tpu.train import Trainer as JaxTrainer
from rfi_toolbox_tpu.train.trainer import _iter_batches as jax_iter_batches
from rfi_toolbox_tpu.train.trainer import export_params as jax_export_params
from rfi_toolbox_tpu.train.trainer import load_params as jax_load_params
from rfi_toolbox_tpu_torch.data import ArrayDataset, BatchWriter, StreamingDataset, TorchDataset
from rfi_toolbox_tpu_torch.evaluation import evaluate_segmentation_batch
from rfi_toolbox_tpu_torch.models import (
    UNet,
    UNetBigger,
    create_model,
    params_from_flax,
    unet_from_snapshot,
)
from rfi_toolbox_tpu_torch.serving import CompiledPredictor
from rfi_toolbox_tpu_torch.train import Trainer, create_train_state, export_params, load_params
from rfi_toolbox_tpu_torch.train.trainer import _batch_indices

HW = 16
FEATURES = 4


def _random_variables(shapes, rng, key=""):
    """Seeded values for a Flax variable tree: kernels ~ N(0, 1/fan_in),
    norm scales and batch variances in [0.5, 1.5], the rest 0.3 N(0, 1)."""
    if isinstance(shapes, dict):
        return {k: _random_variables(v, rng, k) for k, v in shapes.items()}
    shape = shapes.shape
    if key == "kernel":
        return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    if key in ("var", "scale"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return (0.3 * rng.normal(size=shape)).astype(np.float32)


def _flax_variables(model, rng, hw):
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, hw, hw, 3)))
    v = _random_variables(dict(shapes), rng)
    return v["params"], v.get("batch_stats", {})


def _port_logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))[:, 0].numpy()


def _flax_logits(model, params, stats, x):
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x)
    return np.asarray(out)[..., 0]


@pytest.mark.parametrize("model_type, kwargs", [
    ("unet", {}),
    ("unet_bigger", {}),
    ("unet_overfit", {}),
    ("unet_activation", {"activation": "leaky_relu"}),
])
def test_create_model_matches_jax(rng, model_type, kwargs):
    """Each registry name builds the same network as the JAX create_model
    (depth 5 for the bigger ones, the sigmoid output of unet_overfit, the
    caller's activation)."""
    hw = 32
    jkw = {k: getattr(fnn, v) for k, v in kwargs.items()}
    pkw = {k: getattr(torch.nn.functional, v) for k, v in kwargs.items()}
    jmodel = jax_create_model(model_type, init_features=2, **jkw)
    pmodel = create_model(model_type, init_features=2, **pkw)
    assert (pmodel.depth, pmodel.final_sigmoid) == (jmodel.depth, jmodel.final_sigmoid)
    params, stats = _flax_variables(jmodel, rng, hw)
    pmodel.load_state_dict(params_from_flax(params, stats, pmodel))
    x = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
    np.testing.assert_allclose(_port_logits(pmodel, x),
                               _flax_logits(jmodel, params, stats, x), atol=1e-4)


def test_create_model_rejects_unknown_names():
    with pytest.raises(ValueError) as port:
        create_model("unet_huge")
    with pytest.raises(ValueError) as ref:
        jax_create_model("unet_huge")
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_snapshots_bit_equal_both_ways(tmp_path, rng, norm):
    """A JAX snapshot read by the port and written back is read by the JAX
    load_params with every array bit-equal to the JAX original."""
    jmodel = FlaxUNet(init_features=FEATURES, norm=norm)
    params, stats = _flax_variables(jmodel, rng, HW)
    jax_path = tmp_path / "jax.npz"
    jax_export_params(params, jax_path, batch_stats=stats, metadata={"norm": norm})
    model, meta = unet_from_snapshot(jax_path)
    assert meta["norm"] == norm and model.depth == 4
    port_path = export_params(model, tmp_path / "port.npz")
    jp, js, jmeta = jax_load_params(port_path)
    flat = jax.tree_util.tree_flatten_with_path
    want = dict(flat({"params": params, "batch_stats": stats})[0])
    got = dict(flat({"params": jp, "batch_stats": js})[0])
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))
    assert jmeta["init_features"] == FEATURES and jmeta["norm"] == norm
    # and the port's own loader reads what the port wrote, unchanged
    pp, ps, _ = load_params(port_path)
    for a, b in zip(jax.tree.leaves((pp, ps)), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(a, b)


def test_port_unet_bigger_is_served_from_its_snapshot(tmp_path, rng):
    """A port-exported UNetBigger (depth 5) serves through from_snapshot,
    given the model or finding the depth in the snapshot."""
    model = UNetBigger(init_features=2, norm="batch")
    params, stats = _flax_variables(FlaxUNet(init_features=2, depth=5), rng, 32)
    model.load_state_dict(params_from_flax(params, stats, model))
    path = export_params(model, tmp_path / "bigger.npz")
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = _port_logits(model, x) > 0
    for given in (UNetBigger(init_features=2, norm="batch"), None):
        pred = CompiledPredictor.from_snapshot(path, model=given, batch_size=2,
                                               input_shape=(32, 32, 3), device="cpu")
        assert pred.model.depth == 5
        assert (pred(x).numpy() != want).mean() < 1e-3


def test_dataset_files_cross_read(tmp_path, rng):
    images = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    labels = (rng.random((4, 8, 8)) < 0.5).astype(np.uint8)
    ArrayDataset(torch.from_numpy(images), labels, {"seed": 3}).save_to_disk(
        tmp_path / "port.npz")
    back = JaxArrayDataset.load_from_disk(tmp_path / "port.npz")
    np.testing.assert_array_equal(back.images, images)
    np.testing.assert_array_equal(back.labels, labels)
    assert back.metadata == {"seed": 3}
    JaxArrayDataset(images, labels, {"k": "v"}).save_to_disk(tmp_path / "jax.npz")
    ds = TorchDataset.load_from_disk(tmp_path / "jax.npz")
    np.testing.assert_array_equal(ds.images, images)
    assert ds.metadata == {"k": "v"} and TorchDataset is ArrayDataset


def test_evaluate_segmentation_batch_matches_jax(rng):
    pred = rng.random((5, 8, 8)) < 0.4
    true = rng.random((5, 8, 8)) < 0.4
    pred[0] = true[0] = False  # the empty/empty edge cases
    got = evaluate_segmentation_batch(torch.from_numpy(pred), torch.from_numpy(true))
    want = jax_eval_batch(pred, true)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("seed, epoch", [(0, 0), (0, 3), (7, 1), (123, 9)])
def test_batch_order_is_jax_order(seed, epoch):
    n, batch = 37, 8
    want = [b for b, _ in jax_iter_batches(np.arange(n), np.arange(n), batch,
                                           np.random.default_rng((seed, epoch)))]
    got = _batch_indices(n, batch, np.random.default_rng((seed, epoch)))
    assert len(got) == len(want) == n // batch
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _toy(rng, n):
    """Patches whose label is a bright vertical stripe."""
    images = rng.normal(0, 0.3, (n, HW, HW, 3)).astype(np.float32)
    labels = np.zeros((n, HW, HW), np.uint8)
    for i in range(n):
        c = rng.integers(3, HW - 3)
        images[i, :, c - 2:c + 2] += 3.0
        labels[i, :, c - 2:c + 2] = 1
    return images, labels


@functools.cache
def _jax_fit():
    """One epoch of the JAX Trainer.fit (16 images, batch 8, two steps
    fused) with a validation set, from its own initial state; returns the
    initial variables, the result and the trainer."""
    rng = np.random.default_rng(21)
    train, val = _toy(rng, 16), _toy(rng, 8)
    trainer = JaxTrainer(FlaxUNet(init_features=FEATURES), seed=5)
    trainer.state = trainer._init_state((HW, HW, 3))
    start = jax.device_get((trainer.state.params, trainer.state.batch_stats))
    result = trainer.fit(JaxArrayDataset(*train), JaxArrayDataset(*val), num_epochs=1,
                         batch_size=8, fused_steps=2)
    return train, val, start, result, trainer


def _port_trainer(start, **kwargs):
    model = UNet(init_features=FEATURES)
    model.load_state_dict(params_from_flax(*start, model))
    trainer = Trainer(model, seed=5, device="cpu", **kwargs)
    trainer.state = create_train_state(model, None, device="cpu")
    return trainer


def test_fit_matches_jax():
    train, val, start, want, _ = _jax_fit()
    trainer = _port_trainer(start)
    got = trainer.fit(ArrayDataset(*train), ArrayDataset(*val), num_epochs=1,
                      batch_size=8, fused_steps=2)
    assert got["epochs_run"] == want["epochs_run"] == 1
    assert trainer.state.step == 2
    g, w = got["history"][0], want["history"][0]
    assert set(g) == set(w)
    for key in ("train_loss", "val_loss"):
        assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), key
    for key in ("val_iou", "val_precision", "val_recall", "val_f1", "val_dice"):
        assert abs(g[key] - w[key]) <= 1e-3, key
    assert got["best_val_loss"] == g["val_loss"]


@pytest.mark.parametrize("tta", [False, True])
def test_predict_matches_jax(tta):
    train, _, _, _, jtrainer = _jax_fit()
    trainer = _port_trainer(jax.device_get((jtrainer.state.params,
                                            jtrainer.state.batch_stats)))
    images = train[0][:5]
    want = jtrainer.predict(images, batch_size=4, tta=tta)
    got = trainer.predict(images, batch_size=4, tta=tta)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert (got.numpy() != want).mean() < 1e-3


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """Two epochs at once, and one epoch, a checkpoint and a resumed
    second epoch in a new trainer, end with the same bits."""
    train, val, start, _, _ = _jax_fit()
    ds, vds = ArrayDataset(*train), ArrayDataset(*val)
    whole = _port_trainer(start)
    whole.fit(ds, vds, num_epochs=2, batch_size=4, fused_steps=2)
    first = _port_trainer(start, checkpoint_dir=tmp_path)
    result = first.fit(ds, vds, num_epochs=1, batch_size=4, fused_steps=2)
    assert first.latest_checkpoint() is not None
    second = Trainer(UNet(init_features=FEATURES), seed=5, device="cpu",
                     checkpoint_dir=tmp_path)
    second.fit(ds, vds, num_epochs=2, batch_size=4, fused_steps=2,
               resume_from=result["final_checkpoint"])
    assert second.state.step == whole.state.step == 8
    for a, b in zip(whole.state.model.state_dict().values(),
                    second.state.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(whole.state.nu, second.state.nu):
        assert torch.equal(a, b)
    assert [h["train_loss"] for h in second.history] == \
        [whole.history[1]["train_loss"]]


def test_fit_reads_npz_and_refuses_directories(tmp_path, rng):
    """``fit`` takes a single ``.npz`` or reference-format ``.pt`` file and,
    since batch directories are streamed, a ``BatchWriter`` directory (it
    refused directories before ``StreamingDataset`` was ported; the name is
    kept)."""
    images, labels = _toy(rng, 4)
    path = ArrayDataset(images, labels).save_to_disk(tmp_path / "train.npz")
    torch.save({"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)},
               tmp_path / "train.pt")
    writer = BatchWriter(tmp_path / "batches", samples_per_batch=3)
    writer.add_batch(ArrayDataset(images, labels))
    writer.finalize()
    for source in (str(path), tmp_path / "train.pt", tmp_path / "batches"):
        trainer = Trainer(UNet(init_features=2, depth=2), device="cpu")
        result = trainer.fit(source, source, num_epochs=1, batch_size=2)
        assert result["epochs_run"] == 1 and trainer.state.step == 2, source
        assert np.isfinite(result["history"][0]["val_loss"]), source


@functools.cache
def _jax_fit_directories(root):
    """One epoch of the JAX Trainer.fit over BatchWriter directories (16
    training images in files of 6, 6 and 4; 8 validation images in files
    of 5 and 3), batch 4, two steps fused; returns the initial variables
    and the result."""
    rng = np.random.default_rng(22)
    for name, (images, labels), per_file in (("train", _toy(rng, 16), 6),
                                             ("val", _toy(rng, 8), 5)):
        writer = JaxBatchWriter(root / name, samples_per_batch=per_file)
        writer.add_batch(JaxArrayDataset(images, labels))
        writer.finalize()
    trainer = JaxTrainer(FlaxUNet(init_features=FEATURES), seed=5)
    trainer.state = trainer._init_state((HW, HW, 3))
    start = jax.device_get((trainer.state.params, trainer.state.batch_stats))
    result = trainer.fit(str(root / "train"), JaxStreamingDataset(root / "val"),
                         num_epochs=1, batch_size=4, fused_steps=2)
    return start, result


def test_fit_on_batch_directories_matches_jax(tmp_path_factory):
    """Both trainers stream the same directories (train through the 3-file
    shuffle pool, val in order): the same minibatches, so the losses agree
    as ``test_fit_matches_jax``'s do."""
    root = tmp_path_factory.mktemp("batches")
    start, want = _jax_fit_directories(root)
    trainer = _port_trainer(start)
    stream = StreamingDataset(root / "train")
    got = trainer.fit(stream, str(root / "val"), num_epochs=1, batch_size=4,
                      fused_steps=2)
    assert trainer.state.step == 4 and stream.max_resident_files <= 3
    g, w = got["history"][0], want["history"][0]
    assert set(g) == set(w)
    for key in ("train_loss", "val_loss"):
        assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), key
    for key in ("val_iou", "val_precision", "val_recall", "val_f1", "val_dice"):
        assert abs(g[key] - w[key]) <= 1e-3, key
