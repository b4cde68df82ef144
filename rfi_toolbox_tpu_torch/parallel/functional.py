"""Collectives that autograd can differentiate, for the mesh paths.

JAX runs one program over a sharded global batch and XLA places the
collectives; here one process runs per device and the reductions across
ranks are written out. Which backward a collective needs depends on
what lies downstream of it:

- :func:`all_reduce_partial`: a sum whose result feeds a value that
  every rank computes in full (a loss from all-reduced partial sums).
  Each rank's backward already holds the whole gradient of that value,
  so the backward is the identity; a summing backward would scale the
  gradient by the group's size.
- :func:`all_reduce_sum`: a sum whose result feeds per-rank work (the
  batch statistics of a BatchNorm over sharded rows). Each rank's
  backward holds only its rows' share of the gradient, so the backward
  sums it over the group.
- :func:`copy_to_group` and :func:`gather_from_group`: a column-parallel
  layer's input (identity forward, summing backward) and output (the
  shards gathered along a dimension; the backward takes this rank's
  slice, since every rank of the group computes the same downstream).
  Written as autograd functions of the port's own: the backward of
  ``torch.distributed.nn.functional.all_gather`` on a subgroup raised
  "Global rank 0 is not part of group" in torch 2.13 with gloo.

Gradients of replicated parameters are summed over the data group
(:func:`all_reduce_grads`): each rank's backward carries its share of
the global loss. :func:`global_grad_norm` counts each sharded tensor once
(its shards' squares summed over the model group) and each replicated
one once.
"""

from collections import namedtuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = ["TPShard", "all_reduce_partial", "all_reduce_sum", "copy_to_group",
           "gather_from_group", "all_reduce_grads", "global_grad_norm", "gather_shard",
           "local_shard", "group_size"]

# A tensor-parallel parameter's place in its full tensor: its shard is
# chunk ``index`` of ``parts`` along ``dim``, over the ranks of ``group``.
TPShard = namedtuple("TPShard", "dim index parts group")


def group_size(group):
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


class _AllReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None


def all_reduce_partial(x, group):
    """Sum ``x`` over ``group``; the backward passes the gradient through."""
    return _AllReducePartial.apply(x, group)


def all_reduce_sum(x, group):
    """Sum ``x`` over ``group``; the backward sums the gradient over it."""
    return _AllReduceSum.apply(x, group)


def copy_to_group(x, group):
    """``x`` unchanged; the backward sums the gradient over ``group``."""
    return _CopyToGroup.apply(x, group)


def gather_from_group(x, group, dim):
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order; the
    backward takes this rank's slice of the gradient."""
    return _GatherFromGroup.apply(x, group, dim)


def all_reduce_grads(grads, group):
    """Sum a list of gradients over ``group`` in one collective; returns
    the summed list."""
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    return list(_unflatten_dense_tensors(flat, grads))


def global_grad_norm(grads, params):
    """The L2 norm of all the gradients as one vector of the full model:
    with no tensor-parallel parameter (no ``tp_shard`` attribute) the
    plain ``vector_norm`` of the per-tensor norms; else the replicated
    tensors' squares plus the sharded ones' summed over the model group."""
    shards = [getattr(p, "tp_shard", None) for p in params]
    if not any(shards):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    replicated = [g for g, s in zip(grads, shards) if s is None]
    sharded = [g for g, s in zip(grads, shards) if s is not None]
    sq = torch.stack(torch._foreach_norm(sharded)).square().sum()
    dist.all_reduce(sq, group=next(s for s in shards if s is not None).group)
    if replicated:
        sq = sq + torch.stack(torch._foreach_norm(replicated)).square().sum()
    return sq.sqrt()


def gather_shard(t, shard):
    """The full tensor of which ``t`` is the ``shard`` (a collective over
    the shard's group); ``t`` itself when ``shard`` is None."""
    if shard is None:
        return t
    return gather_from_group(t.detach(), shard.group, shard.dim)


def local_shard(full, shard):
    """This rank's chunk of ``full`` (``full`` itself when ``shard`` is
    None)."""
    if shard is None:
        return full
    return full.chunk(shard.parts, shard.dim)[shard.index]
