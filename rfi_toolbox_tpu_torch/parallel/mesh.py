"""Device mesh and sharding helpers.

Counterpart of ``rfi_toolbox_tpu/parallel/mesh.py``. JAX puts one array
across a ``Mesh`` of chips and XLA inserts the collectives; here one
process runs per device, a :class:`Mesh` names the process group's axes
(``torch.distributed.device_mesh.init_device_mesh``), and each helper
gives a rank its own part:

- ``data``: batch data parallelism. :func:`shard_batch` returns this
  rank's rows; a batch whose leading dimension does not divide the axis
  is kept whole on every rank (JAX's replication rule, ``mesh.py:66-82``),
  and its :func:`batch_placement` is :func:`replicated`, whose ``group``
  is None, so that nothing sums it over the ranks.
- ``model``: tensor parallelism over conv output channels.
  :func:`shard_params_tensor_parallel` applies JAX's rule (output
  features >= ``min_features`` and divisible by the axis) by putting a
  :class:`ColumnParallelConv` in place of each such conv: it holds its
  slice of the output channels (weight and bias) and gathers the full
  output over the ``model`` group.

Ranks are laid out row-major on the mesh, as JAX reshapes its device
list: rank ``d * model + m`` is at (data ``d``, model ``m``).
"""

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from ..utils.device import resolve_device
from .functional import TPShard, copy_to_group, gather_from_group, gather_shard, local_shard

__all__ = [
    "Mesh",
    "ColumnParallelConv",
    "Placement",
    "make_mesh",
    "replicated",
    "batch_sharding",
    "batch_placement",
    "shard_batch",
    "shard_params_tensor_parallel",
    "shard_waterfalls",
    "gather_tensor_parallel_state",
    "world_size",
]


def world_size():
    """Processes in the job: the process group's size, else torchrun's
    ``WORLD_SIZE``, else 1. Initialises nothing."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


class Mesh:
    """Named axes over the job's processes, one device each.

    Attributes:
        shape: ``{axis name: size}``, in axis order.
        axis_names: the names, in order.
        device_type: ``"cuda"`` or ``"cpu"``.
        device_mesh: the ``torch.distributed`` ``DeviceMesh``.
    """

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in device_mesh.mesh.shape)))
        self.device_type = device_mesh.device_type

    @property
    def device(self):
        """This rank's device."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def get_group(self, axis):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def local_rank(self, axis):
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def _ensure_process_group(device_type):
    """A process group for this job: torchrun's when its environment is
    set (``initialize_distributed``), else one of this process alone."""
    if dist.is_initialized():
        return
    from .distributed import initialize_distributed

    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        initialize_distributed(backend=backend)
        if not dist.is_initialized():
            raise RuntimeError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} is set but the "
                               "process group did not start (see the warning above)")
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape=None, axis_names=("data", "model"), device_type=None):
    """A :class:`Mesh` over the job's processes.

    Args:
        shape: sizes matching ``axis_names``; None: all processes on the
            first axis, 1 on the rest.
        axis_names: the axes, default ('data', 'model').
        device_type: ``"cuda"`` (None; raises without a card) or
            ``"cpu"``.

    Raises ``ValueError`` when the shape's product is not the number of
    processes; the check comes before any process group is started.
    Without one, starts torchrun's (NCCL on the card, gloo on the CPU)
    or, outside torchrun, one of this process alone.
    """
    device_type = resolve_device(device_type).type
    n = world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(math.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    _ensure_process_group(device_type)
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(device_type, tuple(int(s) for s in shape),
                                 mesh_dim_names=tuple(axis_names)))


@dataclass(frozen=True)
class Placement:
    """Where a batch lies on a mesh: its leading dimension split over
    ``axis`` (each rank its contiguous block of rows), or, with ``axis``
    None, whole on every rank."""

    mesh: Mesh
    axis: str = None

    @property
    def group(self):
        """The group over which per-rank partial sums add up to the
        batch's: None when the batch is replicated or the axis has one
        rank."""
        if self.axis is None or self.mesh.shape[self.axis] == 1:
            return None
        return self.mesh.get_group(self.axis)

    def local(self, a, dim=0):
        """This rank's part of ``a`` along ``dim`` (a view)."""
        if self.axis is None:
            return a
        n = self.mesh.shape[self.axis]
        size = a.shape[dim] // n
        return a.narrow(dim, self.mesh.local_rank(self.axis) * size, size)


def replicated(mesh):
    """Whole on every rank."""
    return Placement(mesh, None)


def batch_sharding(mesh, axis="data"):
    """The leading (batch) dimension split over ``axis``."""
    return Placement(mesh, axis)


def batch_placement(n, mesh, axis="data"):
    """JAX's rule for a batch of ``n`` rows: split over ``axis`` when
    ``n`` divides it, else replicated."""
    if n and n % mesh.shape[axis] == 0:
        return batch_sharding(mesh, axis)
    return replicated(mesh)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh, axis="data"):
    """This rank's rows of every array of a pytree (dicts, lists, tuples
    of numpy arrays or tensors), as tensors on the mesh's device. An array
    whose leading dimension does not divide the axis (or a scalar) is
    returned whole: :func:`batch_placement` says so for its length."""

    def put(a):
        a = torch.as_tensor(a)
        if a.ndim:
            a = batch_placement(a.shape[0], mesh, axis).local(a)
        return a.to(mesh.device)

    return _tree_map(put, batch)


def shard_waterfalls(waterfalls, mesh, axis="data"):
    """This rank's waterfalls of a (B, ..., C, T) batch, split over
    ``axis``; B must divide it (reshape a large observation's baselines x
    pols into the leading dimension first)."""
    n = mesh.shape[axis]
    if waterfalls.shape[0] % n:
        raise ValueError(f"{waterfalls.shape[0]} waterfalls do not divide the mesh's "
                         f"{axis!r} axis ({n})")
    return batch_sharding(mesh, axis).local(torch.as_tensor(waterfalls)).to(mesh.device)


class ColumnParallelConv(nn.Module):
    """A ``Conv2d`` or ``ConvTranspose2d`` holding chunk ``index`` of
    ``parts`` of its output channels, weight and bias alike; the forward
    convolves the full input (cast, as the port's convs do, to the input's
    dtype) and gathers the full output over ``group``. Parameters carry a
    ``tp_shard`` attribute (:class:`TPShard`), and loading a full
    ``state_dict`` takes this rank's chunk, so a checkpoint of the
    unsharded model loads as it is."""

    def __init__(self, conv, group, index, parts):
        super().__init__()
        self.transposed = isinstance(conv, nn.ConvTranspose2d)
        dim = 1 if self.transposed else 0  # the weight's output-channel axis
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        self.output_padding = getattr(conv, "output_padding", 0)
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.group = group
        self.weight = nn.Parameter(conv.weight.detach().chunk(parts, dim)[index].clone())
        self.weight.tp_shard = TPShard(dim, index, parts, group)
        if conv.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(conv.bias.detach().chunk(parts)[index].clone())
            self.bias.tp_shard = TPShard(0, index, parts, group)

    def forward(self, x):
        x = copy_to_group(x, self.group)
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.transposed:
            y = nn.functional.conv_transpose2d(x, w, b, self.stride, self.padding,
                                               self.output_padding, self.groups,
                                               self.dilation)
        else:
            y = nn.functional.conv2d(x, w, b, self.stride, self.padding, self.dilation,
                                     self.groups)
        return gather_from_group(y, self.group, 1)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        for name in ("weight", "bias"):
            p, key = getattr(self, name), prefix + name
            if p is not None and key in state_dict and state_dict[key].shape != p.shape:
                state_dict[key] = local_shard(state_dict[key], p.tp_shard)
        super()._load_from_state_dict(state_dict, prefix, *args)


def shard_params_tensor_parallel(module, mesh, min_features=256, axis="model"):
    """JAX's tensor-parallel rule on a torch module, in place: every
    ``Conv2d``/``ConvTranspose2d`` (ungrouped) with at least
    ``min_features`` output channels, divisible by the axis, becomes a
    :class:`ColumnParallelConv` holding this rank's chunk; everything
    else stays replicated. Returns ``module``. A state built on the
    sharded parameters (Adam's moments) then has the shards' sizes."""
    parts = mesh.shape[axis]
    if parts == 1:
        return module
    group, index = mesh.get_group(axis), mesh.local_rank(axis)
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if (isinstance(child, (nn.Conv2d, nn.ConvTranspose2d)) and child.groups == 1
                    and child.out_channels >= min_features
                    and child.out_channels % parts == 0):
                setattr(parent, name, ColumnParallelConv(child, group, index, parts))
    return module


def gather_tensor_parallel_state(module):
    """``module.state_dict()`` with every tensor-parallel parameter
    gathered to its full size: the unsharded model's ``state_dict`` (a
    collective over the model groups; every rank must call it)."""
    params = dict(module.named_parameters())
    return {k: gather_shard(v, getattr(params.get(k), "tp_shard", None))
            for k, v in module.state_dict().items()}
