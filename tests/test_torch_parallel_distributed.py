"""Process-group start-up through the port's helpers, on the CPU.

Counterpart of ``tests/test_distributed.py``: two real processes join
through ``initialize_distributed`` (gloo), build a ``global_mesh`` and sum
across processes; the failure rules are JAX's: an explicit (or partly
explicit) request that cannot be met RAISES, and only the argument-free
auto-detect falls back to one process, with a warning. ``make_mesh``
refuses a shape that is not the world size before it starts anything.
"""

import logging
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as R
from rfi_toolbox_tpu_torch.parallel import initialize_distributed, make_mesh, process_info

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


@pytest.fixture
def no_torchrun(monkeypatch):
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()


@pytest.mark.parametrize("world", [2, 4])
def test_processes_join_and_sum(world, tmp_path):
    results = R.run_ranks("global_sum", world, tmp_path)
    total = float(sum(range(world * 4)))
    for rank, res in enumerate(results):
        assert res["info"] == (rank, world)
        assert res["mesh"] == {"data": world, "model": 1}
        assert res["sum"] == total


def test_explicit_coordinator_failure_is_loud():
    """An unreachable explicit coordinator raises (never SWALLOWED)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(R.ROOT)!r})
        from rfi_toolbox_tpu_torch.parallel import initialize_distributed
        try:
            initialize_distributed(coordinator_address="localhost:1", num_processes=2,
                                   process_id=1, backend="gloo", initialization_timeout=5)
        except Exception as e:
            print("RAISED", type(e).__name__, flush=True)
            raise SystemExit(17)
        print("SWALLOWED", flush=True)
    """)
    proc = subprocess.run([sys.executable, "-c", code], env=R.worker_env(),
                          capture_output=True, text=True, timeout=R.TIMEOUT_S)
    assert "SWALLOWED" not in proc.stdout, proc.stdout
    assert proc.returncode == 17, (proc.returncode, proc.stdout, proc.stderr)


def test_partial_explicit_spec_is_also_loud(no_torchrun, caplog):
    """num_processes/process_id without a coordinator is an explicit
    request: no coordinator in the environment raises, naming it."""
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(num_processes=2, process_id=1, backend="gloo")
    assert not dist.is_initialized()
    assert any("FAILED" in r.message for r in caplog.records)


def test_autodetect_fallback_returns_false_and_warns(no_torchrun, caplog):
    with caplog.at_level(logging.WARNING, logger="rfi_toolbox_tpu_torch.parallel.distributed"):
        assert initialize_distributed(backend="gloo") is False
        assert initialize_distributed() is False  # no card: NCCL cannot be had either
    assert not dist.is_initialized()
    assert sum("single-process" in r.message for r in caplog.records) == 2


def test_before_any_process_group(no_torchrun, monkeypatch):
    assert process_info()[:2] == (0, 1)
    with pytest.raises(ValueError, match=r"mesh shape \(2, 1\) != 1 devices"):
        make_mesh((2, 1), device_type="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match=r"mesh shape \(2, 1\) != 4 devices"):
        make_mesh((2, 1), device_type="cpu")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((4,), axis_names=("data",))  # the card by default
