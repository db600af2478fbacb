"""Manual ring collectives with serialized vs double-buffered schedules,
on the stacked blocks of a single-controller mesh (:mod:`.mesh`).

Port of ``repro.comm.ring``, the paper's §4 finding and fix:

  * ``schedule="serial"`` — one queue. Each ring step's ppermute is chained
    behind the consumer's use of the previous chunk, so compute waits on
    the wire every step (the BlockingProgress-lock pattern). The
    reference pins that order with ``jax.lax.optimization_barrier``; here
    the controller waits for the card's stream at that point
    (:func:`repro_torch.device.fence`).
  * ``schedule="overlap"`` — two queues. Step k's compute has no data
    dependency on step k+1's permute, which is queued right behind it.

All functions run inside :func:`.mesh.shard_map` and take stacked
tensors. Where the reference indexes a rank's block by its own
``axis_index`` (``dynamic_update_index_in_dim``), the port does it for
every rank at once (:func:`_take`, :func:`_put`). The matmuls are
``torch.matmul``, as the reference leaves them to XLA outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import regions
from ..device import fence
from . import patterns
from .collectives import comm_phase, ppermute, reduce_scatter_blocks
from .mesh import current_mesh


def _ring_perm(n: int, reverse: bool = False):
    return patterns.ring_perm(n, -1 if reverse else 1)


def _ranks(axis_name: str):
    """(stacked dimension, size, positions 0..n-1) of mesh axis
    ``axis_name`` in the active mesh."""
    mesh = current_mesh()
    n = mesh.axis_size(axis_name)
    return mesh.dim(axis_name), n, torch.arange(n, device=mesh.device)


def _take(t: torch.Tensor, d: int, idx: torch.Tensor) -> torch.Tensor:
    """Rank r (along stacked dimension d) takes index ``idx[r]`` of its
    block's first dimension: ``dynamic_index_in_dim`` on every rank."""
    nd = current_mesh().ndim
    ar = torch.arange(t.shape[d], device=t.device)
    return t.movedim((d, nd), (0, 1))[ar, idx].movedim(0, d)


def _put(t: torch.Tensor, d: int, idx: torch.Tensor, val: torch.Tensor
         ) -> None:
    """Rank r writes its block of ``val`` at index ``idx[r]`` of its
    block of ``t``, in place: ``dynamic_update_index_in_dim`` on every
    rank."""
    nd = current_mesh().ndim
    ar = torch.arange(t.shape[d], device=t.device)
    t.movedim((d, nd), (0, 1))[ar, idx] = val.movedim(d, 0)


def ring_all_gather(
    x: torch.Tensor, axis_name: str, schedule: str = "overlap"
) -> torch.Tensor:
    """All-gather each rank's block x along axis_name via a ppermute ring.
    Every rank's block becomes (n * x_block.shape[0], ...), with rank i's
    block at block i."""
    nd = current_mesh().ndim
    d, n, idx = _ranks(axis_name)
    perm = _ring_perm(n)
    out = x.new_zeros((*x.shape[:nd], n, *x.shape[nd:]))
    _put(out, d, idx, x)
    cur = x
    with regions.annotate(f"ring_all_gather({axis_name})",
                          category="collective", schedule=schedule), \
            comm_phase(f"ring_all_gather({axis_name})"):
        for step in range(1, n):
            nxt = ppermute(cur, axis_name, perm, tag=step)
            if schedule == "serial":
                # one queue: chain the send behind the consumer's update
                fence(nxt, out)
            _put(out, d, (idx - step) % n, nxt)
            cur = nxt
    return out.reshape(*x.shape[:nd], n * x.shape[nd], *x.shape[nd + 1:])


def ring_all_reduce(
    x: torch.Tensor, axis_name: str, schedule: str = "overlap"
) -> torch.Tensor:
    """reduce-scatter + all-gather ring all-reduce by chunks."""
    nd = current_mesh().ndim
    d, n, idx = _ranks(axis_name)
    if n == 1:
        return x
    lead, rows = x.shape[:nd], x.shape[nd]
    flat = x.reshape(*lead, rows, -1)
    pad = -rows % n
    xp = torch.nn.functional.pad(flat, (0, 0, 0, pad)) if pad else flat
    chunks = xp.reshape(*lead, n, -1, xp.shape[-1])    # (n, rows/n, cols)
    perm = _ring_perm(n, reverse=True)

    with regions.annotate(f"ring_all_reduce({axis_name})",
                          category="collective", schedule=schedule), \
            comm_phase(f"ring_all_reduce({axis_name})"):
        # reduce-scatter phase: after n-1 steps, rank i holds the full sum
        # of chunk (i+1) % n
        acc = _take(chunks, d, (idx + 1) % n)
        for step in range(1, n):
            moved = ppermute(acc, axis_name, perm, tag=step)
            mine = _take(chunks, d, (idx + 1 + step) % n)
            if schedule == "serial":
                fence(moved, mine)
            acc = moved + mine
        # all-gather phase
        out = torch.zeros_like(chunks)
        _put(out, d, idx, acc)
        cur = acc
        for step in range(1, n):
            cur = ppermute(cur, axis_name, perm, tag=n + step)
            if schedule == "serial":
                fence(cur, out)
            _put(out, d, (idx + step) % n, cur)
    whole = out.reshape(*lead, -1, xp.shape[-1])
    if pad:
        whole = whole[(slice(None),) * nd + (slice(0, rows),)]
    return whole.reshape(x.shape)


def overlap_matmul_allgather(
    x_shard: torch.Tensor,    # each rank: (rows, K), its shard of X rows
    w: torch.Tensor,          # each rank: (K, N), its local weight
    axis_name: str,
    schedule: str = "overlap",
) -> torch.Tensor:
    """Compute allgather(x) @ w with the gather fused into the matmul:
    step k multiplies the chunk that just arrived while the next chunk is
    queued on the wire. The serial schedule gathers everything first."""
    nd = current_mesh().ndim
    d, n, idx = _ranks(axis_name)
    perm = _ring_perm(n)
    lead, rows = x_shard.shape[:nd], x_shard.shape[nd]

    if schedule == "serial":
        full = ring_all_gather(x_shard, axis_name, schedule="serial")
        return full @ w

    out = x_shard.new_zeros((*lead, n, rows, w.shape[-1]))
    cur = x_shard
    with regions.annotate(f"ag_matmul({axis_name})", category="collective",
                          schedule=schedule), \
            comm_phase(f"ag_matmul({axis_name})"):
        for step in range(n):
            if step < n - 1:
                nxt = ppermute(cur, axis_name, perm, tag=step)  # queue #2
            _put(out, d, (idx - step) % n, cur @ w)             # queue #1
            if step < n - 1:
                cur = nxt
    return out.reshape(*lead, n * rows, w.shape[-1])


def reduce_scatter_matmul(
    x: torch.Tensor,          # each rank: (M, K), its activations
    w_shard: torch.Tensor,    # each rank: (K, N), its row-parallel shard
    axis_name: str,
    schedule: str = "overlap",
    n_chunks: Optional[int] = None,
) -> torch.Tensor:
    """y = reduce_scatter(x @ w, rows): every rank keeps its rows of the
    summed product. ``n_chunks`` is unused, as in the reference."""
    nd = current_mesh().ndim
    d, n, idx = _ranks(axis_name)
    partial = x @ w_shard
    if n == 1:
        return partial
    if schedule == "serial":
        summed = ring_all_reduce(partial, axis_name, schedule="serial")
        lead = partial.shape[:nd]
        rows = partial.shape[nd] // n
        per_rank = summed.reshape(*lead, n, rows, *partial.shape[nd + 1:])
        return _take(per_rank, d, idx)
    # overlap: one reduce-scatter, as the reference's psum_scatter
    return reduce_scatter_blocks(partial, axis_name, scatter_dimension=0)
