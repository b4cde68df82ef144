"""Ranks of the port's mesh paths, run as separate processes on the CPU.

The ``tests/test_torch_parallel_*.py`` files import this module for
:func:`run_ranks`, which starts ``world`` processes of it joined by gloo
(``initialize_distributed`` with an explicit coordinator on localhost),
each running one case function on the same inputs, and returns what each
rank produced. A hung collective is killed at the launch's timeout and
fails its test. Importing this module imports neither JAX nor the JAX
package; the processes import only torch, numpy and the port.

    python tests/torch_parallel_ranks.py CASE RANK WORLD PORT WORKDIR
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

# the trainer cases: UNet(init_features=4) on 16 x 16 images, as the JAX
# tensor-parallel tests train it, and tp_min_features 32
HW, N_IMAGES, FEATURES, TP_MIN = 16, 24, 4, 32


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "2"
    return env


def communicate_all(procs, timeout):
    """Wait for every process (all killed at ``timeout`` seconds); returns
    their outputs and whether the launch timed out."""
    deadline = time.monotonic() + timeout
    outs, timed_out = [], False
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    return outs, timed_out


def run_ranks(case, world, workdir, inputs=None, timeout=TIMEOUT_S):
    """Run ``case`` on ``world`` gloo ranks in ``workdir``; ``inputs`` (a
    dict) is saved there for them. Returns the ranks' result dicts."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs or {}, workdir / "inputs.pt")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(rank), str(world), str(port), str(workdir)],
        cwd=ROOT, env=worker_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    outs, timed_out = communicate_all(procs, timeout)
    assert not timed_out, f"{case} at world {world}: killed at {timeout} s\n" + outs[0][-3000:]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{case} rank {rank} failed:\n{out[-4000:]}"
    return [torch.load(workdir / f"{case}_{rank}.pt", weights_only=False)
            for rank in range(world)]


def run_torchrun(argv, world, timeout=TIMEOUT_S):
    """``python argv...`` in ``world`` processes with torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``); returns their (return code, output) pairs."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**worker_env(), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank)}
        procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs, timed_out = communicate_all(procs, timeout)
    assert not timed_out, f"{argv} at world {world}: killed at {timeout} s\n" + outs[0][-3000:]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


# -- shared data ---------------------------------------------------------------------------------
def toy_images(n=N_IMAGES, seed=0):
    """Images with a bright vertical stripe and its label, numpy."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 0.3, (n, HW, HW, 3)).astype(np.float32)
    labels = np.zeros((n, HW, HW), np.uint8)
    for i in range(n):
        c = rng.integers(3, HW - 3)
        images[i, :, c - 2:c + 2] += 3.0
        labels[i, :, c - 2:c + 2] = 1
    return images, labels


def unet_trainer(**kwargs):
    from rfi_toolbox_tpu_torch.models import UNet
    from rfi_toolbox_tpu_torch.train import Trainer

    return Trainer(UNet(init_features=FEATURES), learning_rate=1e-3, seed=0,
                   tp_min_features=TP_MIN, device="cpu", **kwargs)


def full_state(trainer):
    """The trainer's full model state and Adam moments (gathered where
    tensor parallel: every rank must call it)."""
    from rfi_toolbox_tpu_torch.parallel.functional import gather_shard
    from rfi_toolbox_tpu_torch.parallel.mesh import gather_tensor_parallel_state

    st = trainer.state
    shards = [getattr(p, "tp_shard", None) for p in st.params]
    return {"model": {k: v.clone() for k, v in gather_tensor_parallel_state(st.model).items()},
            "mu": [gather_shard(m, s).clone() for m, s in zip(st.mu, shards)],
            "nu": [gather_shard(v, s).clone() for v, s in zip(st.nu, shards)]}


def instance_trainer(**kwargs):
    from rfi_toolbox_tpu_torch.models import SOLOLite
    from rfi_toolbox_tpu_torch.train import InstanceTrainer

    model = SOLOLite(num_classes=6, grid_size=4, embed_dim=8, features=4)
    return InstanceTrainer(model=model, patch_size=32, batch_size=4, seed=3, device="cpu",
                           **kwargs)


def coherent_trainer(**kwargs):
    from rfi_toolbox_tpu_torch.train import CoherentTrainer

    return CoherentTrainer(init_features=4, size=32, batch_size=4, seed=2, norm="batch",
                           learning_rate=1e-3, device="cpu", **kwargs)


# -- cases ---------------------------------------------------------------------------------------
def case_spatial(inp, world):
    """preprocess_sharded, flag_waterfalls(mesh=) (mad and model),
    flag_measurement_set(mesh=) and sharded_global_stats on a data mesh of
    all the ranks."""
    from rfi_toolbox_tpu_torch.io import flag_measurement_set, flag_waterfalls, make_fake_ms
    from rfi_toolbox_tpu_torch.parallel import make_mesh
    from rfi_toolbox_tpu_torch.parallel.spatial import preprocess_sharded, sharded_global_stats

    mesh = make_mesh(axis_names=("data",), device_type="cpu")
    out = {"mesh": dict(mesh.shape)}
    out["preprocess"] = [preprocess_sharded(wf, mesh, patch_size=inp["patch"])
                         for wf in inp["preprocess"]]
    out["flags_mad"] = [flag_waterfalls(wf, method="mad", sigma=5.0, patch_size=inp["patch"],
                                        mesh=mesh, device="cpu") for wf in inp["flag"]]
    out["flags_model"] = [flag_waterfalls(wf, method="model", patch_size=inp["patch"],
                                          predictor=lambda im: im[..., 0] > 0.5,
                                          mesh=mesh, device="cpu") for wf in inp["flag"]]
    out["stats"] = sharded_global_stats(inp["stats"], mesh)
    out["ms"] = {}
    for streaming in (False, True):
        ms = make_fake_ms(**inp["ms"])
        res = flag_measurement_set(ms, method="mad", patch_size=inp["patch"],
                                   streaming=streaming, mesh=mesh, device="cpu")
        out["ms"][streaming] = (res, np.stack([r["FLAG"] for r in ms.rows]))
    return out


def case_train(inp, world):
    """Trainer.fit on each mesh shape of ``inp["shapes"]`` at each batch
    size of ``inp["batch_sizes"]``: the history, the full state after the
    epoch, and the tensor-parallel chunks' shapes."""
    from rfi_toolbox_tpu_torch.data import ArrayDataset

    images, labels = toy_images()
    out = {}
    for shape in inp["shapes"]:
        for bs in inp["batch_sizes"]:
            trainer = unet_trainer(mesh_shape=shape)
            res = trainer.fit(ArrayDataset(images, labels),
                              ArrayDataset(images[:8], labels[:8]), num_epochs=1,
                              batch_size=bs)
            tp = [(tuple(p.shape), tuple(m.shape), p.tp_shard.dim, p.tp_shard.parts)
                  for p, m in zip(trainer.state.params, trainer.state.mu)
                  if hasattr(p, "tp_shard")]
            out[(shape, bs)] = {"history": res["history"], "state": full_state(trainer),
                                "tp": tp}
    return out


def case_checkpoint(inp, world):
    """At mesh (2, 2): two epochs straight; one epoch with a checkpoint,
    resumed from it to epoch 2; and a resume from the meshless checkpoint
    ``inp["meshless_ckpt"]`` to epoch 2."""
    from rfi_toolbox_tpu_torch.data import ArrayDataset

    ds = ArrayDataset(*toy_images())
    straight = unet_trainer(mesh_shape=(2, 2)).fit(ds, num_epochs=2, batch_size=8)
    first = unet_trainer(mesh_shape=(2, 2), checkpoint_dir=inp["dir"]).fit(
        ds, num_epochs=1, batch_size=8)
    own = unet_trainer(mesh_shape=(2, 2)).fit(ds, num_epochs=2, batch_size=8,
                                               resume_from=first["final_checkpoint"])
    resumed = unet_trainer(mesh_shape=(2, 2))
    second = resumed.fit(ds, num_epochs=2, batch_size=8, resume_from=inp["meshless_ckpt"])
    return {"straight": straight["history"], "first": first["history"],
            "ckpt": first["final_checkpoint"], "own": own["history"],
            "resumed": second["history"], "state": full_state(resumed)}


def case_coherent_instance(inp, world):
    """CoherentTrainer and InstanceTrainer (one step at a time and fused) on
    a data mesh of all the ranks."""
    from rfi_toolbox_tpu_torch.parallel import make_mesh

    mesh = make_mesh((world,), axis_names=("data",), device_type="cpu")
    coh = coherent_trainer(mesh=mesh)
    h = coh.fit(inp["steps"], fused_steps=1, log_every=1)["history"]
    out = {"coherent": {"losses": [r["loss"] for r in h],
                        "params": [p.detach().clone() for p in coh.state.params],
                        "ema": [e.clone() for e in coh.ema_params],
                        "sample": coh.sample(0)}}
    for fused in (1, inp["steps"]):
        inst = instance_trainer(mesh_shape=(world, 1))
        h = inst.fit(num_steps=inp["steps"], log_every=1, fused_steps=fused)["history"]
        out[f"instance_{fused}"] = {"history": h, "params": [p.detach().clone()
                                                           for p in inst.state.params]}
    return out


def case_global_sum(inp, world):
    """global_mesh and process_info, then a sum over the processes."""
    import torch.distributed as dist

    from rfi_toolbox_tpu_torch.parallel import global_mesh, process_info

    mesh = global_mesh(model_axis=1, device_type="cpu")
    rank, count, _ = process_info()
    x = torch.arange(count * 4, dtype=torch.float32).reshape(count, 4)[rank].sum()
    dist.all_reduce(x, group=mesh.get_group("data"))
    return {"info": (rank, count), "mesh": dict(mesh.shape), "sum": float(x)}


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(argv):
    case, rank, world, port, workdir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(2)
    from rfi_toolbox_tpu_torch.parallel import initialize_distributed

    ok = initialize_distributed(coordinator_address=f"localhost:{port}",
                                num_processes=world, process_id=rank, backend="gloo",
                                initialization_timeout=60)
    assert ok == (world > 1)
    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    result = CASES[case](inputs, world)
    torch.save(result, Path(workdir) / f"{case}_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
