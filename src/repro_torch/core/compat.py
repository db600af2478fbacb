"""Mesh constructors under the reference's names (port of
``repro.core.compat``).

The reference has one kind of mesh; the port has two, and each name keeps
the role it has at its call sites:

* :func:`make_mesh`, :func:`shard_map` and :func:`axis_size` are the
  single-controller mesh of :mod:`repro_torch.comm.mesh`: one process
  drives every rank's block, and the comm layer's collectives act along
  the mesh's dimensions (the examples' tours use them).
* :func:`mesh_from_devices` builds a ``torch.distributed`` ``DeviceMesh``
  over one rank a process, from an explicit array of ranks: the
  constructor of the elastic restart path and of
  :func:`repro_torch.launch.mesh.make_mesh_for`.

:func:`axis_types_kwargs` is a JAX version shim with nothing to bridge
here: it returns ``{}``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..comm.mesh import Mesh, axis_size, shard_map

__all__ = ["axis_size", "axis_types_kwargs", "make_mesh", "mesh_from_devices",
           "shard_map"]


def axis_types_kwargs(n_axes: int) -> dict:
    """No mesh axis types to set on a ``DeviceMesh``: ``{}``."""
    return {}


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device="cpu") -> Mesh:
    """A single-controller :class:`~repro_torch.comm.mesh.Mesh` of
    ``axis_shapes`` ranks along ``axis_names``, every block on ``device``."""
    return Mesh(tuple(axis_shapes), tuple(axis_names), device=device)


def mesh_from_devices(rank_array, axis_names: Sequence[str],
                      device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the ranks of ``rank_array`` (an int array
    whose shape is the mesh's), dimensions named ``axis_names``. The
    default process group must be initialised; ``device_type`` defaults
    to ``cuda`` under NCCL and ``cpu`` otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.as_tensor(np.asarray(rank_array, dtype=np.int64))
    if ranks.dim() != len(axis_names):
        raise ValueError(f"rank array of shape {tuple(ranks.shape)} for "
                         f"axes {tuple(axis_names)}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))
