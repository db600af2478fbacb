"""Differentiable collectives on local shards, for code inside
``local_map`` (the counterparts of ``psum`` and ``psum_scatter`` inside the
reference's ``shard_map``).

Their gradients follow DTensor's convention: the gradient that reaches a
``local_map`` output placed ``Replicate()`` is already the total on every
rank, so :func:`psum`'s backward passes it through; the gradient of a
``Shard(d)`` output is each rank's block, so :func:`psum_scatter`'s
backward all-gathers it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim = group, dim
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((xs.shape[0] // n,) + xs.shape[1:])
        dist.reduce_scatter_tensor(out, xs, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        gs = g.movedim(ctx.dim, 0).contiguous()
        out = gs.new_empty((gs.shape[0] * n,) + gs.shape[1:])
        dist.all_gather_into_tensor(out, gs, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, on every rank."""
    return _Psum.apply(x, group)


def psum_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, split along ``dim``: rank
    ``i`` keeps block ``i`` (``tiled=True`` in JAX's terms)."""
    return _PsumScatter.apply(x, group, dim)
