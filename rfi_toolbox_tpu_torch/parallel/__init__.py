"""Runs over several devices: one process a device, joined by
``torch.distributed`` (NCCL on the cards, gloo on the CPU).

Counterpart of ``rfi_toolbox_tpu/parallel`` (its nine names), with the
collectives that XLA places there written out in ``functional``.
"""

from .distributed import global_mesh, initialize_distributed, process_info
from .mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
    shard_params_tensor_parallel,
    shard_waterfalls,
)

__all__ = [
    "make_mesh",
    "replicated",
    "batch_sharding",
    "shard_batch",
    "shard_params_tensor_parallel",
    "shard_waterfalls",
    "initialize_distributed",
    "global_mesh",
    "process_info",
]
