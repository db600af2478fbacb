"""Production meshes (port of ``repro.launch.mesh``).

Meshes are ``torch.distributed`` ``DeviceMesh``es over the ranks of the
default process group, one rank a process (a card, or a CPU process
under gloo), built by functions, never at import. The production mesh
needs its 256 or 512 ranks; :func:`production_mesh_shape` gives its shape
without them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.compat import mesh_from_devices


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return mesh_from_devices(np.arange(int(np.prod(shape))).reshape(shape),
                             axes, device_type)


def mesh_for_shape(n_devices: int, model_parallel: int = 1
                   ) -> Tuple[int, int]:
    """(data, model) of :func:`make_mesh_for`; ``ValueError`` when
    ``model_parallel`` does not divide ``n_devices``."""
    if model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not divide "
                         f"the {n_devices} devices")
    return n_devices // model_parallel, model_parallel


def make_mesh_for(n_devices: int, model_parallel: int = 1,
                  device_type: Optional[str] = None):
    """(data, model) mesh over the first ``n_devices`` ranks (the world
    size, for the launcher and the elastic restart path)."""
    data, model = mesh_for_shape(n_devices, model_parallel)
    return mesh_from_devices(np.arange(n_devices).reshape(data, model),
                             ("data", "model"), device_type)
