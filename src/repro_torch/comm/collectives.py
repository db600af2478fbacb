"""Instrumented collective primitives (the 'MPI procedure calls'), on the
stacked blocks of a single-controller mesh (:mod:`.mesh`).

Port of ``repro.comm.collectives``. Each wrapper runs inside
:func:`.mesh.shard_map` and takes a stacked tensor: the mesh axes lead,
the local block follows. A collective over mesh axis ``a`` is an
operation along ``a``'s dimension, with ``jax.lax``'s semantics
(``ppermute`` leaves zeros where no rank sends). Each annotates its
dispatch site with the reference's profiling region (category
"collective", ``bytes=`` one rank's block) and mirrors it into the
PyTorch profiler with ``record_function`` under the name the reference
gives ``jax.named_scope``.

When a matching fabric is configured (:func:`configure_matching`), every
wrapper routes its point-to-point decomposition through the
message-matching engine (:mod:`repro_torch.match`) exactly as the
reference does, once per dispatch, from the one controller.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch

from ..core import regions
from .mesh import axis_index, axis_size, current_mesh  # noqa: F401

_FABRIC = None                       # Optional[repro_torch.match.Fabric]


def configure_matching(fabric) -> None:
    """Install (or, with None, remove) the matching fabric every comm-layer
    dispatch is decomposed into. Runtime-toggleable like region categories."""
    global _FABRIC
    _FABRIC = fabric


def matching_fabric():
    return _FABRIC


@contextlib.contextmanager
def comm_phase(label: str):
    """Label the fabric phase markers emitted while the body runs, so a
    recorded trace names phases after the dispatch site (ring schedules
    and halo faces use this). No-op when no fabric is configured."""
    fab = _FABRIC
    if fab is None:
        yield
        return
    prev = fab.set_label(label)
    try:
        yield
    finally:
        fab.set_label(prev)


def _nbytes(x: torch.Tensor) -> int:
    """Bytes of one rank's block of stacked ``x``."""
    nd = current_mesh().ndim
    n = 1
    for s in x.shape[nd:]:
        n *= s
    return int(n * x.element_size())


def _local_dim(axis: int) -> int:
    """The stacked dimension of dimension ``axis`` of a rank's block."""
    return current_mesh().ndim + axis


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    mesh = current_mesh()
    with regions.annotate(f"psum({axis_name})", category="collective",
                          bytes=_nbytes(x)):
        if _FABRIC is not None:
            with comm_phase(f"psum({axis_name})"):
                _FABRIC.all_reduce(mesh.axis_size(axis_name),
                                   nbytes=_nbytes(x))
        with torch.profiler.record_function(f"comm_psum_{axis_name}"):
            d = mesh.dim(axis_name)
            return x.sum(dim=d, keepdim=True).expand_as(x).contiguous()


def all_gather(x: torch.Tensor, axis_name: str, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    mesh = current_mesh()
    with regions.annotate(f"all_gather({axis_name})", category="collective",
                          bytes=_nbytes(x)):
        if _FABRIC is not None:
            with comm_phase(f"all_gather({axis_name})"):
                _FABRIC.all_gather(mesh.axis_size(axis_name),
                                   nbytes=_nbytes(x))
        with torch.profiler.record_function(f"comm_all_gather_{axis_name}"):
            d, n = mesh.dim(axis_name), mesh.axis_size(axis_name)
            # one block dimension fewer once the mesh axis is selected away
            at = _local_dim(axis) - 1
            blocks = [x.select(d, j) for j in range(n)]
            whole = torch.cat(blocks, at) if tiled else torch.stack(blocks, at)
            return whole.unsqueeze(d).expand(
                *x.shape[:d], n, *whole.shape[d:]).contiguous()


def reduce_scatter_blocks(x: torch.Tensor, axis_name: str,
                          scatter_dimension: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(..., tiled=True)`` on stacked blocks, with no
    region and no fabric: the sum over ``axis_name``, of which rank j
    keeps chunk j along block dimension ``scatter_dimension``."""
    mesh = current_mesh()
    d, n = mesh.dim(axis_name), mesh.axis_size(axis_name)
    total = x.sum(dim=d)
    chunks = total.chunk(n, dim=_local_dim(scatter_dimension) - 1)
    if len(chunks) != n or any(c.shape != chunks[0].shape for c in chunks):
        raise ValueError(f"block dimension {scatter_dimension} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    return torch.stack(chunks, dim=d)


def reduce_scatter(x: torch.Tensor, axis_name: str,
                   scatter_dimension: int = 0) -> torch.Tensor:
    mesh = current_mesh()
    with regions.annotate(f"reduce_scatter({axis_name})",
                          category="collective", bytes=_nbytes(x)):
        if _FABRIC is not None:
            with comm_phase(f"reduce_scatter({axis_name})"):
                _FABRIC.reduce_scatter(mesh.axis_size(axis_name),
                                       nbytes=_nbytes(x))
        with torch.profiler.record_function(
                f"comm_reduce_scatter_{axis_name}"):
            return reduce_scatter_blocks(x, axis_name, scatter_dimension)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    mesh = current_mesh()
    with regions.annotate(f"all_to_all({axis_name})", category="collective",
                          bytes=_nbytes(x)):
        if _FABRIC is not None:
            with comm_phase(f"all_to_all({axis_name})"):
                _FABRIC.all_to_all(mesh.axis_size(axis_name),
                                   nbytes=_nbytes(x))
        with torch.profiler.record_function(f"comm_all_to_all_{axis_name}"):
            d, n = mesh.dim(axis_name), mesh.axis_size(axis_name)
            # chunk j of every rank's block goes to rank j, which
            # concatenates what it receives in rank order
            chunks = x.chunk(n, dim=_local_dim(split_axis))
            if len(chunks) != n:
                raise ValueError(f"block dimension {split_axis} of "
                                 f"{tuple(x.shape)} does not split {n} ways")
            at = _local_dim(concat_axis) - 1
            return torch.stack(
                [torch.cat([c.select(d, i) for i in range(n)], at)
                 for c in chunks], dim=d)


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]],
             tag: int = 0) -> torch.Tensor:
    """``tag`` distinguishes envelopes of back-to-back permutes with the
    same pattern (ring steps, halo faces) in the matching engine. Rank
    ``dst`` of each ``(src, dst)`` pair receives ``src``'s block; a rank
    that no pair names receives zeros."""
    mesh = current_mesh()
    with regions.annotate(f"ppermute({axis_name})", category="collective",
                          bytes=_nbytes(x)):
        if _FABRIC is not None:
            _FABRIC.ppermute(perm, nbytes=_nbytes(x), tag=tag)
        with torch.profiler.record_function(f"comm_ppermute_{axis_name}"):
            d = mesh.dim(axis_name)
            out = torch.zeros_like(x)
            if perm:
                src, dst = _perm_index(tuple(perm), x.device)
                out.index_copy_(d, dst, x.index_select(d, src))
            return out


_PERM_INDEX = {}


def _perm_index(perm: Tuple[Tuple[int, int], ...], device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sources, destinations) of ``perm`` as index tensors on ``device``,
    made once: a host-to-device copy at every dispatch would wait for the
    work queued before it, fencing every permute."""
    key = (perm, device)
    idx = _PERM_INDEX.get(key)
    if idx is None:
        idx = _PERM_INDEX[key] = tuple(
            torch.tensor(side, device=device) for side in zip(*perm))
    return idx


