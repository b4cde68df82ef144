"""Process-group initialisation for runs over several devices.

Counterpart of ``rfi_toolbox_tpu/parallel/distributed.py``. JAX connects
each host to a coordinator and then sees every device of the job; torch
runs one process per device, joined in a ``torch.distributed`` process
group: NCCL between cards, gloo on the CPU (the tests). Under ``torchrun``
the topology comes from its environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).
"""

import datetime
import logging
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "global_mesh", "process_info"]


def _env_int(name):
    value = os.environ.get(name)
    return None if value is None else int(value)


def _init_method(coordinator_address):
    """``tcp://host:port`` from ``coordinator_address``, or from
    ``MASTER_ADDR``/``MASTER_PORT``; raises ValueError without either."""
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError(
                "coordinator_address should be defined: pass it, or set MASTER_ADDR "
                "and MASTER_PORT (torchrun does)")
        coordinator_address = f"{addr}:{port}"
    return f"tcp://{coordinator_address}"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, **kwargs):
    """Join this process to the job's process group.

    Args:
        coordinator_address: ``"host:port"`` of rank 0's store; None reads
            ``MASTER_ADDR``/``MASTER_PORT``.
        num_processes, process_id: the world size and this rank; None
            reads ``WORLD_SIZE``/``RANK``.
        backend: ``"nccl"``, ``"gloo"``; None is NCCL on the card (and
            raises without one, as every entry point does: pass
            ``"gloo"`` for the CPU).
        kwargs: ``initialization_timeout`` (seconds, JAX's name) or
            ``init_process_group``'s own.

    On the card, ``torch.cuda.set_device(LOCAL_RANK)`` (or the rank
    modulo the local cards) runs first, so that ``device=None`` is this
    rank's card. Returns True when the job has more than one process.

    Failure semantics (JAX's): when any topology argument was given, a
    failed init RAISES, since a misconfigured job must not quietly train
    on a fraction of the data; only the argument-free auto-detect call
    falls back to one process, with a warning, and returns False.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = any(
        a is not None for a in (coordinator_address, num_processes, process_id))
    timeout = kwargs.pop("initialization_timeout", None)
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    try:
        if backend is None:
            resolve_device(None)
            backend = "nccl"
        world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
        rank = process_id if process_id is not None else _env_int("RANK")
        init_method = _init_method(coordinator_address)
        if world is None or rank is None:
            raise ValueError("num_processes and process_id should be defined: pass "
                             "them, or set WORLD_SIZE and RANK (torchrun does)")
        if backend == "nccl":
            local = _env_int("LOCAL_RANK")
            torch.cuda.set_device(rank % torch.cuda.device_count() if local is None
                                  else local)
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank, **kwargs)
    except (ValueError, RuntimeError) as e:
        if explicit:
            logger.error(
                "initialize_distributed(coordinator=%s, n=%s, id=%s) FAILED: %s",
                coordinator_address, num_processes, process_id, e)
            raise
        logger.warning(
            "multi-host auto-detect failed (%s); continuing single-process. "
            "Pass coordinator_address explicitly to make this an error.", e)
        return False
    return dist.get_world_size() > 1


def global_mesh(axis_names=("data", "model"), model_axis=1, device_type=None):
    """Mesh over all the job's processes: ``(world // model_axis,
    model_axis)``. Put the model axis within a host (its ranks are
    consecutive), the data axis across hosts."""
    from .mesh import make_mesh, world_size

    n = world_size()
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model axis {model_axis}")
    return make_mesh(shape=(n // model_axis, model_axis), axis_names=axis_names,
                     device_type=device_type)


def process_info():
    """(rank, world size, local device count): the process's place in the
    job (0, 1 before any init) and the cards it sees (1 on a machine
    without one: the CPU)."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return rank, world, max(torch.cuda.device_count(), 1)
