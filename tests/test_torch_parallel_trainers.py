"""The trainers on a mesh: data parallel and tensor parallel steps against
the meshless port, on gloo ranks on the CPU.

Counterpart of ``tests/test_tensor_parallel.py`` (and of the checkpoint
case of ``tests/test_distributed.py``). The meshless port's steps are
pinned to JAX by ``test_torch_train.py::test_train_steps_match_jax``;
here the mesh runs are held to the meshless ones, from the same seed on
the same batches (``torch_parallel_ranks``; one launch a case and world
size, each killed at 120 s):

- ``Trainer(mesh_shape=...)`` at (2, 1), (4, 1) and (2, 2) with
  ``UNet(init_features=4)`` and ``tp_min_features=32``, as the JAX tests
  run it: one epoch of 24 images with validation, at a batch that divides
  the data axis (8) and at one that does not (5 on 2 ranks, 6 on 4:
  replicated). Losses and metrics within 1e-5 (sums of the same terms in
  another order). Parameters after the epoch: Adam moves a coordinate
  by about the learning rate a step whatever its gradient's size, so
  where a gradient coordinate is float32 noise its direction is noise:
  every coordinate within lr / 2 of the meshless run and 99% within
  lr / 100; the ranks' states equal bit for bit.
- the tensor-parallel chunks (weight and Adam's moments) have half the
  output channels of the full conv;
- checkpoints: one from (2, 2) restores at (1, 1) and one from (1, 1) at
  (2, 2), each continuing within 1e-5 of the meshless run; a (2, 2) run
  resumed from its own checkpoint follows the uninterrupted one exactly;
- ``CoherentTrainer`` and ``InstanceTrainer`` at data 2: the samples
  each rank renders are its rows of the meshless batch, bit for bit, and
  the steps follow the meshless ones within the same tolerances.
"""

import contextlib

import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.models import UNet as FlaxUNet
from rfi_toolbox_tpu.train import CoherentTrainer as JaxCoherentTrainer
from rfi_toolbox_tpu.train import InstanceTrainer as JaxInstanceTrainer
from rfi_toolbox_tpu.train import Trainer as JaxTrainer
from rfi_toolbox_tpu_torch.data import ArrayDataset
from rfi_toolbox_tpu_torch.models import UNet
from rfi_toolbox_tpu_torch.train import CoherentTrainer, InstanceTrainer, Trainer
import torch_parallel_ranks as R

LR = 1e-3  # the trainers' learning rate in these cases
LOSS_ATOL = 1e-5
TRAIN_CASES = {2: ([(2, 1)], [8, 5]), 4: ([(4, 1), (2, 2)], [8, 6])}


@contextlib.contextmanager
def _ranks_threads():
    """The ranks' thread count, so that a replicated batch's convolutions
    sum in the same order as the meshless reference's."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    return {w: R.run_ranks("train", w, tmp_path_factory.mktemp(f"train{w}"),
                           {"shapes": shapes, "batch_sizes": sizes})
            for w, (shapes, sizes) in TRAIN_CASES.items()}


@pytest.fixture(scope="module")
def meshless():
    images, labels = R.toy_images()
    out = {}
    with _ranks_threads():
        for bs in sorted({b for _, sizes in TRAIN_CASES.values() for b in sizes}):
            trainer = R.unet_trainer()
            res = trainer.fit(ArrayDataset(images, labels),
                              ArrayDataset(images[:8], labels[:8]), num_epochs=1,
                              batch_size=bs)
            out[bs] = {"history": res["history"], "state": R.full_state(trainer)}
    return out


def _params_close(got, want, what):
    """Every coordinate within lr / 2, and 99% within lr / 100."""
    diff = torch.cat([(g.double() - w.double()).abs().flatten() for g, w in zip(got, want)])
    assert float(diff.max()) <= LR / 2, (what, float(diff.max()))
    share = float((diff <= LR / 100).double().mean())
    assert share >= 0.99, (what, share)


def _records_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k != "seconds":
                assert g[k] == pytest.approx(w[k], abs=LOSS_ATOL), k


def _model_params(state):
    return [v for k, v in state["model"].items() if "running" not in k and "num_batches" not in k]


@pytest.mark.parametrize("world,shape,bs", [
    (w, s, b) for w, (shapes, sizes) in TRAIN_CASES.items() for s in shapes for b in sizes])
def test_trainer_on_the_mesh_matches_meshless(world, shape, bs, train_ranks, meshless):
    results = train_ranks[world]
    got, want = results[0][(shape, bs)], meshless[bs]
    _records_close(got["history"], want["history"])
    _params_close(_model_params(got["state"]), _model_params(want["state"]), (shape, bs))
    _params_close(got["state"]["mu"], want["state"]["mu"], (shape, bs, "mu"))
    for k, v in want["state"]["model"].items():
        if "running" in k:  # BatchNorm's running statistics, the whole batch's
            np.testing.assert_allclose(got["state"]["model"][k], v, rtol=1e-4, atol=1e-5)
    for other in results[1:]:  # every rank holds the same state and history
        o = other[(shape, bs)]
        assert [r["train_loss"] for r in o["history"]] == [r["train_loss"]
                                                           for r in got["history"]]
        for a, b in zip(o["state"]["mu"] + _model_params(o["state"]),
                        got["state"]["mu"] + _model_params(got["state"])):
            assert torch.equal(a, b)


def test_tp_params_actually_sharded(train_ranks):
    """At (2, 2) with tp_min_features 32, the convs of 32 and 64 output
    channels hold half of them, and Adam's moments have the chunks' shapes;
    at (4, 1) nothing is sharded."""
    full = {k: v.shape for k, v in R.unet_trainer().model.state_dict().items()}
    for bs in TRAIN_CASES[4][1]:
        assert train_ranks[4][0][((4, 1), bs)]["tp"] == []
        tp = train_ranks[4][0][((2, 2), bs)]["tp"]
        assert len(tp) >= 6
        for shape, mu_shape, dim, parts in tp:
            assert shape == mu_shape and parts == 2
            assert shape[dim] * 2 in (32, 64)
        assert sum(np.prod(s) for s, *_ in tp) * 2 <= sum(np.prod(s) for s in full.values())


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    ds = ArrayDataset(*R.toy_images())
    with _ranks_threads():
        straight = R.unet_trainer().fit(ds, num_epochs=2, batch_size=8)["history"]
        first = R.unet_trainer(checkpoint_dir=root / "meshless").fit(ds, num_epochs=1,
                                                                     batch_size=8)
    ranks = R.run_ranks("checkpoint", 4, root / "ranks",
                        {"dir": str(root / "mesh"), "meshless_ckpt": first["final_checkpoint"]})
    return {"straight": straight, "ranks": ranks}


def test_checkpoint_from_2x2_restores_meshless_and_back(checkpoints):
    ranks = checkpoints["ranks"]
    r0 = ranks[0]
    assert all(r["ckpt"] == r0["ckpt"] for r in ranks)
    tree = torch.load(r0["ckpt"], weights_only=True)
    full = R.unet_trainer()
    full.state = full._init_state()
    assert tree["model"].keys() == full.state.model.state_dict().keys()
    for k, v in full.state.model.state_dict().items():  # the meshless format, full sizes
        assert tree["model"][k].shape == v.shape
    assert [m.shape for m in tree["mu"]] == [p.shape for p in full.state.params]
    # (2, 2) -> (1, 1): the restored state is the checkpoint's, bit for bit
    with _ranks_threads():
        trainer = R.unet_trainer()
        resumed = trainer.fit(ArrayDataset(*R.toy_images()), num_epochs=2, batch_size=8,
                              resume_from=r0["ckpt"])["history"]
    assert [r["epoch"] for r in resumed] == [2]
    _records_close(resumed, checkpoints["straight"][1:])
    _records_close(r0["first"], checkpoints["straight"][:1])
    # (1, 1) -> (2, 2)
    _records_close(r0["resumed"], checkpoints["straight"][1:])


def test_checkpoint_resumes_exactly_on_the_mesh(checkpoints):
    r0 = checkpoints["ranks"][0]
    assert [r["train_loss"] for r in r0["own"]] == [r0["straight"][1]["train_loss"]]
    assert r0["first"][0]["train_loss"] == r0["straight"][0]["train_loss"]


def test_restore_takes_each_ranks_chunk():
    """A full state loads into a tensor-parallel conv as its chunk, and
    ``local_shard`` cuts Adam's moments the same way (no process group:
    the chunking only)."""
    from rfi_toolbox_tpu_torch.parallel.functional import TPShard, local_shard
    from rfi_toolbox_tpu_torch.parallel.mesh import ColumnParallelConv

    conv = torch.nn.ConvTranspose2d(6, 8, 2, stride=2)
    tp = ColumnParallelConv(conv, None, 1, 2)
    assert tp.weight.shape == (6, 4, 2, 2) and tp.bias.shape == (4,)
    assert torch.equal(tp.weight, conv.weight[:, 4:]) and torch.equal(tp.bias, conv.bias[4:])
    full = {"weight": torch.randn(6, 8, 2, 2), "bias": torch.randn(8)}
    tp.load_state_dict(full)
    assert torch.equal(tp.weight, full["weight"][:, 4:])
    assert torch.equal(tp.bias, full["bias"][4:])
    assert torch.equal(local_shard(full["weight"], TPShard(1, 0, 2, None)),
                       full["weight"][:, :4])


@pytest.fixture(scope="module")
def coherent_instance(tmp_path_factory):
    return R.run_ranks("coherent_instance", 2, tmp_path_factory.mktemp("ci"), {"steps": 3})


def test_coherent_trainer_on_data_2_matches_meshless(coherent_instance):
    with _ranks_threads():
        tr = R.coherent_trainer()
        losses = [r["loss"] for r in tr.fit(3, fused_steps=1, log_every=1)["history"]]
        x, y = tr.sample(0)
    r0, r1 = coherent_instance
    for got, want in ((r0["coherent"]["sample"][0], x[:2]), (r1["coherent"]["sample"][0], x[2:]),
                      (r0["coherent"]["sample"][1], y[:2]), (r1["coherent"]["sample"][1], y[2:])):
        assert torch.equal(got, want)  # each rank renders its rows of the same draws
    np.testing.assert_allclose(r0["coherent"]["losses"], losses, atol=LOSS_ATOL, rtol=0)
    assert r1["coherent"]["losses"] == r0["coherent"]["losses"]
    _params_close(r0["coherent"]["params"], [p.detach() for p in tr.state.params], "coherent")
    _params_close(r0["coherent"]["ema"], tr.ema_params, "coherent ema")


@pytest.mark.parametrize("fused", [1, 3])
def test_instance_trainer_on_data_2_matches_meshless(fused, coherent_instance):
    with _ranks_threads():
        tr = R.instance_trainer()
        history = tr.fit(num_steps=3, log_every=1, fused_steps=fused)["history"]
    for r in coherent_instance:
        got = r[f"instance_{fused}"]
        _records_close([{k: v for k, v in h.items() if k != "steps_per_sec"}
                        for h in got["history"]],
                       [{k: v for k, v in h.items() if k != "steps_per_sec"} for h in history])
        _params_close(got["params"], [p.detach() for p in tr.state.params], "instance")


def test_trainer_rejects_mesh_and_mesh_shape():
    with pytest.raises(ValueError, match="not both") as jax_err:
        JaxTrainer(FlaxUNet(out_channels=1, init_features=4), mesh=object(), mesh_shape=(4, 2))
    with pytest.raises(ValueError, match="not both") as port_err:
        Trainer(UNet(init_features=4), mesh=object(), mesh_shape=(4, 2), device="cpu")
    assert str(port_err.value) == str(jax_err.value)


class _DataMesh:
    shape = {"data": 4}


def test_coherent_batch_must_divide_the_data_axis():
    with pytest.raises(ValueError) as jax_err:
        JaxCoherentTrainer(init_features=2, size=32, batch_size=6, mesh=_DataMesh())
    with pytest.raises(ValueError) as port_err:
        CoherentTrainer(init_features=2, size=32, batch_size=6, mesh=_DataMesh(), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert "must divide the mesh's 'data' axis (4)" in str(port_err.value)


def test_instance_trainer_is_data_only():
    for shape in ((2, 2), (1, 1, 2)):
        with pytest.raises(ValueError) as jax_err:
            JaxInstanceTrainer(patch_size=32, batch_size=4, mesh_shape=shape)
        with pytest.raises(ValueError) as port_err:
            InstanceTrainer(patch_size=32, batch_size=4, mesh_shape=shape, device="cpu")
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="not both"):
        InstanceTrainer(patch_size=32, mesh=object(), mesh_shape=(2,), device="cpu")
