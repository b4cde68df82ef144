"""Port parity of the channel-sharded preprocessing and the mesh flagging
paths, on gloo ranks on the CPU.

Counterpart of ``tests/test_spatial.py``. The same numpy inputs go through
the JAX package on its 8-virtual-device mesh (``tests/conftest.py``) and
through the port on a data mesh of 2 and of 4 processes
(``torch_parallel_ranks.case_spatial``, one launch a world size):

- ``preprocess_sharded`` within 2e-5 of JAX's, channel counts that
  divide the shards and ones that do not;
- ``flag_waterfalls(mesh=)`` (mad) flags equal to JAX's, on one large
  waterfall (the channel split) and on 15 waterfalls (replicated: 15
  divides neither 2 nor 4), and the model method equal to the meshless
  port's;
- ``sharded_global_stats``: the median exact, the mean within 1e-5 and
  the std within 1e-4 relative;
- ``flag_measurement_set(mesh=)`` (bulk and streaming) writes the
  meshless FLAG column and returns the meshless result.

Every rank must hold the same result. Each launch is killed at 120 s.
"""

import jax
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.io import flag_waterfalls as jax_flag_waterfalls
from rfi_toolbox_tpu.parallel import make_mesh as jax_make_mesh
from rfi_toolbox_tpu.parallel.spatial import preprocess_sharded as jax_preprocess_sharded
from rfi_toolbox_tpu.parallel.spatial import sharded_global_stats as jax_global_stats
from rfi_toolbox_tpu_torch.io import flag_measurement_set, flag_waterfalls, make_fake_ms
from rfi_toolbox_tpu_torch.parallel.mesh import (
    Placement,
    batch_placement,
    batch_sharding,
    replicated,
    shard_batch,
)
from torch_parallel_ranks import run_ranks

PATCH = 16
WORLDS = (2, 4)
TOL = 2e-5  # the extraction's bound (rfi_toolbox_tpu/ops/fused_channels.py:17-19)
MS = dict(num_antennas=4, channels_per_spw=(32,), num_times=48, seed=1)


def _waterfalls(rng, shape, bright_rows=None):
    base = rng.normal(1.0, 0.1, shape)
    if bright_rows is not None:
        base[:, bright_rows, :] += 1e4
    return (base * np.exp(1j * rng.uniform(0, 6.28, base.shape))).astype(np.complex64)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    return {
        "patch": PATCH,
        # 256 channels: 2 patch rows a shard of 8; then channel counts
        # that divide no shard count
        "preprocess": [_waterfalls(rng, (2, 8 * PATCH * 2, PATCH * 3), slice(40, 44)),
                       _waterfalls(rng, (2, 100, 32)), _waterfalls(rng, (2, 17, 40)),
                       _waterfalls(rng, (2, PATCH * 3, 33))],
        # one waterfall each (the channel split), then 15 (replicated)
        "flag": [_waterfalls(rng, (1, c, t), slice(min(c - 1, 40), min(c, 44)))
                 for c, t in ((PATCH * 8, PATCH * 2), (100, 40), (PATCH * 3, PATCH))]
        + [_waterfalls(rng, (15, 64, 48), slice(10, 12))],
        "stats": np.abs(rng.normal(5, 2, (8 * 1000,))).astype(np.float32),
        "ms": MS,
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each world size's ranks' results, one launch each."""
    return {w: run_ranks("spatial", w, tmp_path_factory.mktemp(f"spatial{w}"), inputs)
            for w in WORLDS}


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(axis_names=("data",))


def _same_on_every_rank(results, key):
    first = results[0][key]
    for other in results[1:]:
        for a, b in zip(first, other[key]):
            assert torch.equal(a, b), key


@pytest.mark.parametrize("world", WORLDS)
def test_preprocess_sharded_matches_jax(world, ranks, inputs, jax_mesh):
    _same_on_every_rank(ranks[world], "preprocess")
    assert ranks[world][0]["mesh"] == {"data": world}
    for wf, got in zip(inputs["preprocess"], ranks[world][0]["preprocess"]):
        want = np.asarray(jax_preprocess_sharded(jax.numpy.asarray(wf), jax_mesh,
                                                 patch_size=PATCH))
        assert got.shape == want.shape, wf.shape
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0, err_msg=str(wf.shape))


@pytest.mark.parametrize("world", WORLDS)
def test_flag_waterfalls_mesh_matches_jax(world, ranks, inputs, jax_mesh):
    """One large waterfall (channel split into patch-aligned slabs) and 15
    waterfalls (replicated): flags equal to JAX's on its mesh and without,
    and to the meshless port."""
    _same_on_every_rank(ranks[world], "flags_mad")
    for wf, got in zip(inputs["flag"], ranks[world][0]["flags_mad"]):
        sharded = np.asarray(jax_flag_waterfalls(wf, method="mad", sigma=5.0,
                                                 patch_size=PATCH, mesh=jax_mesh))
        plain = np.asarray(jax_flag_waterfalls(wf, method="mad", sigma=5.0,
                                               patch_size=PATCH))
        np.testing.assert_array_equal(got.numpy(), sharded, err_msg=str(wf.shape))
        np.testing.assert_array_equal(got.numpy(), plain, err_msg=str(wf.shape))
        mine = flag_waterfalls(wf, method="mad", sigma=5.0, patch_size=PATCH, device="cpu")
        assert torch.equal(got, mine)


@pytest.mark.parametrize("world", WORLDS)
def test_flag_waterfalls_model_method_on_the_mesh(world, ranks, inputs):
    """The model method: each rank's patches through the predictor, flags
    gathered, equal to the meshless port's."""
    _same_on_every_rank(ranks[world], "flags_model")
    for wf, got in zip(inputs["flag"], ranks[world][0]["flags_model"]):
        want = flag_waterfalls(wf, method="model", patch_size=PATCH,
                               predictor=lambda im: im[..., 0] > 0.5, device="cpu")
        assert torch.equal(got, want), wf.shape
        assert 0 < float(got.float().mean()) < 1


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_global_stats_matches_jax(world, ranks, inputs, jax_mesh):
    x = inputs["stats"]
    want = jax_global_stats(jax.numpy.asarray(x), jax_mesh)
    for rank in ranks[world]:
        got = rank["stats"]
        assert got == ranks[world][0]["stats"]
        assert got["median"] == want["median"] == float(np.median(x))
        assert got["mean"] == pytest.approx(want["mean"], rel=1e-5)
        assert got["mean"] == pytest.approx(float(x.mean()), rel=1e-5)
        assert got["std"] == pytest.approx(want["std"], rel=1e-4)
        assert got["std"] == pytest.approx(float(x.std()), rel=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_flag_measurement_set_mesh_writes_the_meshless_column(world, ranks):
    """Rank 0 writes the FLAG column that the meshless call writes (bulk
    and streaming; 24 waterfalls divide both world sizes), and every rank
    returns the meshless result."""
    for streaming in (False, True):
        ms = make_fake_ms(**MS)
        want = flag_measurement_set(ms, method="mad", patch_size=PATCH, streaming=streaming,
                                    device="cpu")
        column = np.stack([r["FLAG"] for r in ms.rows])
        assert column.any()
        res, written = ranks[world][0]["ms"][streaming]
        assert res == want
        np.testing.assert_array_equal(written, column)
        for other in ranks[world][1:]:
            assert other["ms"][streaming][0] == want


class _StubMesh:
    """What the placement helpers read of a mesh: sizes, this rank's index
    on an axis, the device."""

    def __init__(self, shape, index):
        self.shape, self.index, self.device = shape, index, torch.device("cpu")

    def local_rank(self, axis):
        return self.index[axis]

    def get_group(self, axis):
        return f"group:{axis}"


def test_batch_placement_follows_jax_replication_rule():
    mesh = _StubMesh({"data": 4, "model": 2}, {"data": 2, "model": 1})
    assert batch_placement(8, mesh) == batch_sharding(mesh)
    assert batch_placement(6, mesh) == replicated(mesh) == Placement(mesh, None)
    assert batch_placement(0, mesh).axis is None
    assert batch_sharding(mesh).group == "group:data" and replicated(mesh).group is None
    one = _StubMesh({"data": 1}, {"data": 0})
    assert batch_sharding(one).group is None  # nothing to sum over one rank
    x = torch.arange(16).reshape(8, 2)
    assert torch.equal(batch_sharding(mesh).local(x), x[4:6])
    assert torch.equal(batch_sharding(mesh).local(x.T, dim=1), x[4:6].T)
    assert replicated(mesh).local(x) is x


def test_shard_batch_takes_this_ranks_rows_of_a_pytree():
    mesh = _StubMesh({"data": 4}, {"data": 3})
    batch = {"images": np.arange(24.0).reshape(8, 3), "labels": [np.arange(8), np.arange(6)],
             "scalar": np.float32(2.0)}
    got = shard_batch(batch, mesh)
    assert torch.equal(got["images"], torch.arange(24.0, dtype=torch.float64).reshape(8, 3)[6:])
    assert torch.equal(got["labels"][0], torch.arange(6, 8))
    assert torch.equal(got["labels"][1], torch.arange(6))  # 6 rows: replicated
    assert float(got["scalar"]) == 2.0
