"""The port's dry run against the reference's own (``test_reduced_dryrun_8dev``'s
cells): yi-6b and deepseek-moe-16b (smoke) on a (2,4) mesh, train (B 4,
T 64) and decode (B 4, a cache of 64).

The reference lowers and compiles each step in one subprocess with 8
forced host devices and reads its compiled module; the port dry-runs the
same cells on an 8-rank fake process group.

* Per-device argument bytes equal ``memory_analysis().argument_size_in_bytes``
  exactly. One difference is the port's own and is added to the
  reference's: serving weights keep their 1-D scales (the norms) in f32,
  as the reference's serve loop leaves them (``_cast``), where the
  reference's dry-run specs hold them in the compute dtype (bf16).
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
"""
import json
import math
import textwrap

import pytest

from repro_torch.configs import archs as torch_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models.model import model_specs

CELLS = [(a, k) for a in ("yi-6b", "deepseek-moe-16b")
         for k in ("train", "decode")]
JAX = textwrap.dedent("""
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
    for arch in ("yi-6b", "deepseek-moe-16b"):
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
            out[arch + "/" + kind] = {
                "argument_bytes": c.memory_analysis().argument_size_in_bytes,
                "flops": hlo_cost.module_cost(c.as_text()).flops}
    print("JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_cells(subproc):
    return json.loads(subproc(JAX, devices=8).split("JSON")[1])


@pytest.fixture(scope="module")
def port_cells():
    return {f"{arch}/{kind}": dryrun.run_cell(
        arch, kind, mesh_shape=(2, 4), device="cpu",
        cfg=torch_archs.get_config(arch, "smoke"),
        shape=ShapeConfig("t", 64, 4, kind), save=False, verbose=False)
        for arch, kind in CELLS}


@pytest.fixture(scope="module")
def subproc():
    from conftest import run_in_subprocess
    return run_in_subprocess


def f32_scales(arch: str) -> int:
    """Bytes the port's serving weights add over the reference's dry-run
    specs on every device: its 1-D scales in f32 (replicated) where the
    specs give bf16."""
    cfg = torch_archs.get_config(arch, "smoke")
    return sum(2 * math.prod(s.shape) for s in model_specs(cfg).values()
               if len(s.shape) == 1 and s.dtype is None)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_are_the_references(jax_cells, port_cells, arch, kind):
    key = f"{arch}/{kind}"
    want = jax_cells[key]["argument_bytes"]
    if kind == "decode":
        want += f32_scales(arch)
    assert port_cells[key]["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_are_within_15_percent_of_the_references(jax_cells, port_cells,
                                                        arch, kind):
    key = f"{arch}/{kind}"
    ratio = (port_cells[key]["walker"]["flops_per_device"]
             / jax_cells[key]["flops"])
    assert 0.85 <= ratio <= 1.15, (key, ratio)
