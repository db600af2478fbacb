"""Elastic restart and meshes (``repro_torch.checkpoint.elastic``,
``repro_torch.launch.mesh``, ``repro_torch.core.compat``) against the JAX
package.

``viable_meshes`` equals the reference's for 1-64 ranks, and so does the
copy inlined in the host package's ``elastic_ranks`` scenario (the host
packages import no torch, so they keep their own). ``reshard_state``
places a host state on a one-rank gloo mesh made from a ``FileStore``.
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.checkpoint import elastic as jax_elastic
from repro_torch.checkpoint import elastic
from repro_torch.configs.archs import get_config
from repro_torch.core import compat
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.model import Model, param_shapes
from repro_torch.optim import adamw
from repro_torch.workloads import scenarios

PREFER = [1, 2, 4, 8, 16]


@pytest.mark.parametrize("prefer_model", PREFER)
def test_viable_meshes_is_the_references(prefer_model):
    for n in range(1, 65):
        assert elastic.viable_meshes(n, prefer_model) == \
            jax_elastic.viable_meshes(n, prefer_model), n


def inlined_viable_meshes():
    """The ``viable_meshes`` defined inside ``scenarios.elastic_ranks``."""
    code = next(c for c in scenarios.elastic_ranks.__code__.co_consts
                if isinstance(c, types.CodeType)
                and c.co_name == "viable_meshes")
    return types.FunctionType(code, {}, "viable_meshes", (16,))


@pytest.mark.parametrize("prefer_model", PREFER)
def test_the_scenarios_copy_is_elastic_viable_meshes(prefer_model):
    copy = inlined_viable_meshes()
    for n in range(1, 65):
        assert copy(n, prefer_model) == elastic.viable_meshes(n, prefer_model)
    assert copy(12) == elastic.viable_meshes(12)


def test_mesh_shapes_and_refusals():
    assert launch_mesh.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert launch_mesh.production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert launch_mesh.mesh_for_shape(8, 2) == (4, 2)
    assert launch_mesh.mesh_for_shape(4, 4) == (1, 4)
    for n, mp in ((1, 2), (6, 4), (4, 0)):
        with pytest.raises(ValueError, match="does not divide"):
            launch_mesh.mesh_for_shape(n, mp)
    assert compat.axis_types_kwargs(3) == {}
    m = compat.make_mesh((2, 4), ("x", "y"))
    assert m.shape == {"x": 2, "y": 4} and compat.shard_map
    assert sorted(compat.__all__) == sorted(
        ["axis_size", "axis_types_kwargs", "make_mesh", "mesh_from_devices",
         "shard_map"])


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_reshard_state_places_a_host_state_on_a_new_mesh(one_rank):
    cfg = get_config("yi-6b", "smoke")
    model = Model(cfg, torch.device("cpu"), trainable=True).init_weights(0)
    params = {n: p.detach() for n, p in model.named_parameters()}
    opt = adamw.init_state(params)
    host = {"params": params, "opt_state": {
        "m": opt["m"], "v": {n: t + 1 for n, t in opt["v"].items()},
        "step": np.int64(3)}, "extra": "kept"}
    mesh = elastic.make_elastic_mesh(prefer_model=4)
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    out = elastic.reshard_state(cfg, host, mesh)
    assert out["extra"] == "kept" and out["opt_state"]["step"] == 3
    shapes = param_shapes(cfg)
    for name, p in out["params"].items():
        assert isinstance(p, DTensor) and tuple(p.shape) == shapes[name]
        assert torch.equal(p.full_tensor(), params[name]), name
        assert torch.equal(out["opt_state"]["v"][name].full_tensor(),
                           host["opt_state"]["v"][name])
    m2 = launch_mesh.make_mesh_for(1, 1)
    assert m2.device_type == "cpu" and tuple(m2.shape) == (1, 1)
