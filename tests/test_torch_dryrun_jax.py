"""The port's dry run against the reference's own (``test_reduced_dryrun_8dev``'s
cells): yi-6b and deepseek-moe-16b (smoke) on a (2,4) mesh, train (B 4,
T 64) and decode (B 4, a cache of 64). jamba-v0.1-52b's two cells are held
the same way in ``tests/test_torch_dryrun_jamba_jax.py``, a module of its
own, so that its JAX compile runs beside this one.

The reference lowers and compiles each step in one subprocess with 8
forced host devices and reads its compiled module; the port dry-runs the
same cells on an 8-rank fake process group.

* Per-device argument bytes equal ``memory_analysis().argument_size_in_bytes``
  exactly. One difference is the port's own and is added to the
  reference's: serving weights keep their 1-D scales (the norms) and the
  SSM's dynamics in f32, as the reference's serve loop leaves them
  (``_cast``), where the reference's dry-run specs hold them in the
  compute dtype (bf16).
* Per-device FLOPs lie within 15% of the reference's ``module_cost``
  (ratios 1.03 and 1.00 for yi-6b train and decode, 1.12 and 1.05 for
  deepseek-moe-16b when this test was written). The two programs count
  the same products at different boundaries: the flash kernel counts 4·D
  FLOPs per unmasked (query, key) pair, while the JAX blockwise attention's
  dots compute whole blocks, masked entries included; PyTorch's
  checkpoint ends the remat's recompute once every saved tensor is back,
  and the chunked loss recomputes its lm-head product in the backward;
  the port's MoE routes a token group that spans batch shards on every
  rank (the router's product repeated), where XLA partitions it.
* Per-device collective wire bytes, the port's over the reference's
  (``collectives_by_opcode`` on both sides, ring costs), lie in [0.25,
  1.5]: 0.525, 0.404, 0.675 and 0.451 for the four cells when this test
  was written (deepseek-moe-16b decode read 5.143 while MoE decode
  gathered its experts). Where the reference's MoE decode emits an
  all-to-all, the port's records one too (the tokens' ``embed`` blocks
  traded for batch rows). On a CPU mesh DTensor turns a ``Shard`` to
  ``Shard`` redistribute into an all-gather and a chunk
  (``torch/distributed/tensor/_collective_utils.py::shard_dim_alltoall``);
  the port's own all-to-alls (MoE's, mamba's channel split) are
  ``all_to_all_single`` and record as all-to-all, and its remaining
  ``Shard`` to ``Shard`` moves (the residual stream's sequence split to
  the batch split at each sublayer, and back) record as all-gathers,
  where a cuda mesh would emit all-to-alls.
"""
import json
import math
import textwrap

import pytest
import torch

from repro_torch.configs import archs as torch_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models.model import model_specs
from repro_torch.models.common import param_dtype
from repro_torch.sharding import rules as R

WIRE_BAND = (0.25, 1.5)
_BF16 = torch.bfloat16
MESH = {"data": 2, "model": 4}


def jax_script(archs) -> str:
    """The reference's dry run of ``archs`` (train and decode, smoke, the
    (2,4) mesh), printed as JSON after ``JSON``: per cell the argument
    bytes, FLOPs, bytes and collectives of ``module_cost``."""
    return textwrap.dedent("""
    import json, jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.archs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch.specs import input_specs
    from repro.models import model as M
    from repro.optim import adamw
    from repro.sharding import rules as R
    from repro.train.step import make_train_step, make_decode_step
    from repro.core import hlo_cost
    from repro.core.compat import make_mesh

    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, "smoke")
        for kind in ("train", "decode"):
            shape = ShapeConfig("t", seq_len=64, global_batch=4, kind=kind)
            rules = R.make_rules(mesh, shape)
            specs = input_specs(cfg, shape)
            param_sh = R.tree_shardings(M.param_axes(cfg), mesh, rules,
                                        M.param_shapes(cfg))
            batch_sh = R.batch_shardings(specs["batch"], mesh, rules)
            if kind == "train":
                opt_sh = {"m": param_sh, "v": param_sh,
                          "step": NamedSharding(mesh, P())}
                step = make_train_step(cfg, adamw.AdamWConfig())
                args = (specs["params"], specs["opt_state"], specs["batch"])
                in_sh = (param_sh, opt_sh, batch_sh)
            else:
                cache_sh = R.cache_shardings(specs["caches"], mesh, rules)
                step = make_decode_step(cfg)
                args = (specs["params"], specs["caches"], specs["batch"],
                        specs["pos"])
                in_sh = (param_sh, cache_sh, batch_sh,
                         NamedSharding(mesh, P()))
            with R.sharding_context(mesh, rules):
                c = jax.jit(step, in_shardings=in_sh).lower(*args).compile()
            mc = hlo_cost.module_cost(c.as_text())
            out[arch + "/" + kind] = {
                "argument_bytes": c.memory_analysis().argument_size_in_bytes,
                "flops": mc.flops, "bytes": mc.bytes_accessed,
                "wire_bytes": mc.collective_wire_bytes,
                "collectives_by_opcode": mc.collectives_by_opcode}
    print("JSON" + json.dumps(out))
    """).replace("ARCHS", repr(tuple(archs)))


def port_cells(archs):
    return {f"{arch}/{kind}": dryrun.run_cell(
        arch, kind, mesh_shape=(2, 4), device="cpu",
        cfg=torch_archs.get_config(arch, "smoke"),
        shape=ShapeConfig("t", 64, 4, kind), save=False, verbose=False)
        for arch in archs for kind in ("train", "decode")}


def f32_scales(arch: str) -> int:
    """Bytes the port's serving weights add over the reference's dry-run
    specs on every device: the local blocks, at (2,4) under the decode
    rules, of the parameters that serving keeps in f32 (1-D scales, the
    SSM's dynamics) where the specs give bf16."""
    cfg = torch_archs.get_config(arch, "smoke")
    rules = R.make_rules(_Mesh(), ShapeConfig("t", 64, 4, "decode"))
    total = 0
    for name, s in model_specs(cfg).items():
        if s.dtype is not None or param_dtype(
                s, s.dtype or _BF16, False, name.rsplit(".", 1)[-1]) is _BF16:
            continue
        pl = R.pspec(s.axes, rules, shape=s.shape, mesh=_Mesh())
        split = math.prod(n for n, p in zip(MESH.values(), pl)
                          if p != R.Replicate())
        total += 2 * math.prod(s.shape) // split
    return total


class _Mesh:
    """The (2,4) mesh's axes, for placements with no process group."""
    shape = MESH


def wire_tables(jax_cell, port_cell) -> str:
    """Both sides' collectives by opcode, for an assertion's message."""
    return (f"reference {json.dumps(jax_cell['collectives_by_opcode'])}; "
            f"port {json.dumps(port_cell['walker']['collectives_by_opcode'])}")


def check_argument_bytes(jax_cells, port_cells, key):
    want = jax_cells[key]["argument_bytes"]
    if key.endswith("/decode"):
        want += f32_scales(key.split("/")[0])
    assert port_cells[key]["memory"]["argument_bytes"] == want


def check_flops(jax_cells, port_cells, key):
    ratio = (port_cells[key]["walker"]["flops_per_device"]
             / jax_cells[key]["flops"])
    assert 0.85 <= ratio <= 1.15, (key, ratio)


def check_wire_bytes(jax_cells, port_cells, key):
    ratio = (port_cells[key]["walker"]["collective_wire_bytes"]
             / jax_cells[key]["wire_bytes"])
    assert WIRE_BAND[0] <= ratio <= WIRE_BAND[1], (
        key, ratio, wire_tables(jax_cells[key], port_cells[key]))


def check_all_to_all(jax_cells, port_cells, key):
    """Where the reference's MoE decode emits an all-to-all, the port
    records one."""
    want = jax_cells[key]["collectives_by_opcode"].get("all-to-all", {})
    got = port_cells[key]["walker"]["collectives_by_opcode"].get(
        "all-to-all", {})
    if want.get("count"):
        assert got.get("count", 0) >= 1, (
            key, wire_tables(jax_cells[key], port_cells[key]))



ARCHS = ("yi-6b", "deepseek-moe-16b")
CELLS = [f"{a}/{k}" for a in ARCHS for k in ("train", "decode")]


@pytest.fixture(scope="module")
def jax_cells(subproc):
    return json.loads(subproc(jax_script(ARCHS), devices=8).split("JSON")[1])


@pytest.fixture(scope="module")
def port():
    return port_cells(ARCHS)


@pytest.fixture(scope="module")
def subproc():
    from conftest import run_in_subprocess
    return run_in_subprocess


@pytest.mark.parametrize("key", CELLS)
def test_argument_bytes_are_the_references(jax_cells, port, key):
    check_argument_bytes(jax_cells, port, key)


@pytest.mark.parametrize("key", CELLS)
def test_flops_are_within_15_percent_of_the_references(jax_cells, port, key):
    check_flops(jax_cells, port, key)


@pytest.mark.parametrize("key", CELLS)
def test_wire_bytes_lie_in_the_band_of_the_references(jax_cells, port, key):
    check_wire_bytes(jax_cells, port, key)


def test_moe_decode_moves_tokens_by_all_to_all_as_the_reference(jax_cells,
                                                                 port):
    key = "deepseek-moe-16b/decode"
    assert jax_cells[key]["collectives_by_opcode"]["all-to-all"]["count"]
    check_all_to_all(jax_cells, port, key)
