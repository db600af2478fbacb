"""Elastic restart: resume a checkpoint on a *different* rank count (port
of ``repro.checkpoint.elastic``).

At 1000+ nodes, restarts rarely come back with the same world size. The
checkpoint stores unsharded (host) arrays; this module picks a new mesh
from whatever ranks survive and re-places every array under the same
logical sharding rules — parameters keep their logical axes, only the
mesh changes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from ..configs.base import ModelConfig
from ..core.compat import mesh_from_devices
from ..models import model as M
from ..sharding import rules as R


def viable_meshes(n_devices: int, prefer_model: int = 16) -> List[Tuple[int, int]]:
    """(data, model) factorizations, best-first: keep model parallelism as
    close to the preferred width as divisibility allows."""
    out = []
    for model in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % model == 0:
            out.append((n_devices // model, model))
    return out


def make_elastic_mesh(ranks: Optional[List[int]] = None,
                      prefer_model: int = 16,
                      device_type: Optional[str] = None):
    """A (data, model) ``DeviceMesh`` over ``ranks`` (default: every rank
    of the process group), the first of :func:`viable_meshes`."""
    ranks = ranks if ranks is not None else list(range(dist.get_world_size()))
    data, model = viable_meshes(len(ranks), prefer_model)[0]
    return mesh_from_devices(np.asarray(ranks).reshape(data, model),
                             ("data", "model"), device_type)


def reshard_state(
    cfg: ModelConfig,
    host_state: Dict[str, Any],
    mesh,
) -> Dict[str, Any]:
    """Place a host train state (CPU tensors or numpy arrays by parameter
    name, as :meth:`CheckpointManager.restore` gives it) onto a new mesh
    under the standard logical rules. Works for any (data, model)
    factorization: every rank passes the same host state."""
    rules = R.make_rules(mesh)
    param_sh = R.tree_shardings(M.param_axes(cfg), mesh, rules,
                                M.param_shapes(cfg))

    def place(host_tree, sh_tree):
        return {name: distribute_tensor(
            torch.as_tensor(np.asarray(host_tree[name])).to(mesh.device_type),
            mesh, sh) for name, sh in sh_tree.items()}

    out: Dict[str, Any] = {}
    if "params" in host_state:
        out["params"] = place(host_state["params"], param_sh)
    if "opt_state" in host_state:
        opt = host_state["opt_state"]
        out["opt_state"] = {
            "m": place(opt["m"], param_sh),
            "v": place(opt["v"], param_sh),
            "step": int(np.asarray(opt["step"])),
        }
    for k, v in host_state.items():
        if k not in out:
            out[k] = v
    return out
