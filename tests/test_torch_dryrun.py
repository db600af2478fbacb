"""The dry run on a fake process group (``repro_torch.launch.dryrun``) and
the pieces it reads: ``launch.specs``, ``core.hlo``'s recorder and
``core.hlo_cost``.

* (a) ``input_specs`` is the reference's, leaf by leaf in shape and
  dtype, for every arch x ``shapes_for`` cell;
* (b) the recorder counts one rank's local work: a matmul sharded on a
  16x16 fake mesh reads the global FLOPs / 256, on its first call and on
  its second (DTensor's sharding propagation runs the op at its global
  shape on the first, in the same fake mode, and is not counted);
* (c) ``CollectiveOp.wire_bytes`` is the reference's for every opcode at
  group sizes 2, 4 and 16;
* (d) the dry run predicts a real run: on 4 gloo ranks at (2,2), yi-6b,
  deepseek-moe-16b and jamba-v0.1-52b (smoke, f32, B 4, T 64) take one
  counted train step (``count_cost``, which counts the CPU's plain
  attention and scan as the kernels they stand in for; ``CommDebugMode``),
  and the dry run of the same cell on a (2,2) fake mesh gives rank 0's
  FLOPs, its collectives by opcode (counts and operand bytes), its flash
  calls by shape and its scan calls (forward and backward) exactly; and
  so does deepseek-moe-16b with its experts widened to 256, whose training
  moves the tokens to the experts where the others gather the experts;
* (e) MoE decode at full size moves tokens, not experts: deepseek-moe-16b
  ``decode_32k`` on the 16x16 mesh (256 fake ranks) gathers no expert
  tensor and moves at most 0.4 GB a device over the wire (2.013 GB when
  every step gathered the experts);
* (h) a real CPU tensor takes the plain version (the fake branch is for
  fake tensors only; a real CUDA tensor's side is
  ``tests/test_torch_kernels_gpu.py::test_a_real_cuda_tensor_never_reaches_the_fake_branch``);
* the command line: a dense cell completes and prints its report, and a
  cell that raises (an arch that does not exist) records ``ok: false``
  with its error.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.configs.base import SHAPES, shapes_for
from repro.core import hlo as jax_hlo
from repro.launch.specs import input_specs as jax_input_specs
from repro_torch.configs import archs as torch_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import cost, hlo
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import dryrun
from repro_torch.launch.specs import input_specs
from torch_rank_workers import counted_train_steps, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in jax_archs.ARCHS
         for s in shapes_for(jax_archs.get_config(a))]
ARCHS = ("yi-6b", "deepseek-moe-16b", "jamba-v0.1-52b")
# the dry run against a real step: each arch, and deepseek-moe-16b with its
# experts widened (d_expert 256), whose training moves the tokens to the
# experts (``moe._sharded_tokens``) where the others gather the experts
RUNS = {**{a: (a, None) for a in ARCHS},
        "deepseek-moe-16b-tokens": ("deepseek-moe-16b", 256)}


def _cfg(name):
    arch, d_expert = RUNS[name]
    cfg = dataclasses.replace(torch_archs.get_config(arch, "smoke"),
                              dtype="float32")
    if d_expert is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, d_expert=d_expert))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_are_the_references(arch, shape):
    want = _leaves(jax_input_specs(jax_archs.get_config(arch), SHAPES[shape]))
    got = _leaves(input_specs(torch_archs.get_config(arch), SHAPES[shape]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert hlo.dtype_name(g.dtype) == jax_hlo_name(w.dtype), path


def jax_hlo_name(dtype) -> str:
    return {"int32": "s32", "float32": "f32", "bfloat16": "bf16"}[str(dtype)]


def test_recorder_counts_a_ranks_share_of_a_sharded_matmul():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    with dryrun.fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(256, 1024, 4096,
                                              dtype=torch.bfloat16),
                                  mesh, [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(4096, 11008,
                                              dtype=torch.bfloat16),
                                  mesh, [Replicate(), Shard(1)])
            flops = []
            for _ in range(2):
                _, rec = hlo.record(lambda: x @ w)
                flops.append(sum(op.flops for op in rec))
                assert [op.name for op in rec if op.flops] == ["aten.mm"]
    assert flops == [2 * 256 * 1024 * 4096 * 11008 / 256] * 2


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("opcode", jax_hlo.COLLECTIVE_OPS)
def test_wire_bytes_are_the_references(opcode, g):
    operand = 3 * 4096
    result = {"all-gather": operand * g,
              "reduce-scatter": operand // g}.get(opcode, operand)
    args = dict(name="%0", opcode=opcode, is_async=True,
                operand_bytes=operand, result_bytes=result, group_size=g,
                num_groups=1, line="")
    assert (hlo.CollectiveOp(**args).wire_bytes
            == jax_hlo.CollectiveOp(**args).wire_bytes)


@pytest.fixture(scope="module")
def predicted(tmp_path_factory):
    """(rank 0's counts of the real 4-rank step, the dry run of each cell)."""
    runs = [(n, _cfg(n), 2, 4, 64) for n in RUNS]
    real = run_ranks(counted_train_steps, 4, runs,
                     store_dir=str(tmp_path_factory.mktemp("dry")),
                     timeout=300)[0]
    dry = {}
    for name, (arch, _) in RUNS.items():
        dry[name] = dryrun.run_cell(
            arch, "train_4k", mesh_shape=(2, 2), device="cpu",
            cfg=_cfg(name), shape=ShapeConfig("t", 64, 4, "train"),
            save=False, verbose=False)
    return real, dry


@pytest.mark.parametrize("arch", list(RUNS))
def test_dry_run_predicts_the_real_steps_flops(predicted, arch):
    real, dry = predicted
    assert dry[arch]["ok"] and dry[arch]["mesh"] == "2x2"
    assert dry[arch]["walker"]["flops_per_device"] == real[arch]["flops"]


@pytest.mark.parametrize("arch", list(RUNS))
def test_dry_run_predicts_the_real_steps_collectives(predicted, arch):
    real, dry = predicted
    got = {k: {"count": d["count"], "operand_bytes": d["operand_bytes"]}
           for k, d in dry[arch]["collectives_unscaled"]["by_opcode"].items()}
    assert got == real[arch]["collectives"]
    assert {k: d["count"] for k, d in got.items()} == real[arch]["comm_counts"]
    assert got


def _layers(arch, mixer):
    cfg = torch_archs.get_config(arch, "smoke")
    return sum(cfg.pattern[l % len(cfg.pattern)].mixer == mixer
               for l in range(cfg.n_layers))


@pytest.mark.parametrize("arch", list(RUNS))
def test_dry_run_predicts_the_real_steps_flash_calls(predicted, arch):
    real, dry = predicted
    assert dry[arch]["flash_launches_by_shape"] == real[arch]["by_shape"]
    layers = _layers(RUNS[arch][0], "attn")
    # full remat: the forward twice, each backward kernel once a layer
    assert real[arch]["by_shape"] == {"fwd/16/causal": 2 * layers,
                                      "dq/16/causal": layers,
                                      "dkv/16/causal": layers}


@pytest.mark.parametrize("arch", list(RUNS))
def test_dry_run_predicts_the_real_steps_scan_calls(predicted, arch):
    real, dry = predicted
    assert dry[arch]["scan_fake_launches"] == real[arch]["scan"]
    layers = _layers(RUNS[arch][0], "mamba")
    # full remat: the forward twice, the backward once a layer
    assert real[arch]["scan"] == {"fwd": 2 * layers, "bwd": layers}


def test_moe_decode_at_full_size_moves_tokens_not_experts():
    """deepseek-moe-16b ``decode_32k`` at full size on 256 fake ranks: no
    all-gather of an expert tensor's block (4 experts x 128 of ``embed`` x
    1408, bf16: 1,441,792 bytes, over the 16 ranks of ``"data"``), one
    all-to-all a MoE layer, and the wire bytes a device within 0.4 GB."""
    cfg = torch_archs.get_config("deepseek-moe-16b")
    r = dryrun.run_cell("deepseek-moe-16b", "decode_32k", device="cpu",
                        save=False, verbose=False)
    sizes = r["walker"]["collectives_by_size"]
    block = (cfg.padded_n_experts // 16) * (cfg.d_model // 16) * \
        cfg.moe.d_expert * 2
    assert block == 1441792
    assert not [k for k in sizes if k.startswith("all-gather@")
                and k.endswith(f"@{block}B/g16")], sorted(sizes)
    moe_layers = sum(cfg.pattern[l % len(cfg.pattern)].ffn == "moe"
                     for l in range(cfg.n_layers))
    a2a = r["walker"]["collectives_by_opcode"]["all-to-all"]["count"]
    assert a2a == moe_layers
    assert r["walker"]["collective_wire_bytes"] <= 0.4e9, r["walker"]


def _qkv():
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=gen)
            for s in ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))]


def test_a_real_cpu_tensor_takes_the_plain_version():
    q, k, v = _qkv()
    launches, fake = flash_attention.launches, dict(
        flash_attention.fake_launches_by_shape)
    out, lse = flash_attention(q, k, v)
    want, want_lse = flash_attention_ref(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert flash_attention.launches == launches
    assert flash_attention.fake_launches_by_shape == fake
    with cost.count_cost() as tally:
        flash_attention(q, k, v)
    # counted as the kernel it stands in for, its own ops not at all
    flops, nbytes = cost.attention_work(2, 32, 32, 4, 2, 16, True, None, 4)
    assert tally.kernels == {"flash_attention_fwd": {
        "launches": 1, "flops": flops, "bytes": nbytes}}
    assert tally.flops == flops and tally.flops_by_op == {}
    assert tally.by_shape == {"fwd/16/causal": 1}


def test_a_fake_tensor_takes_the_fake_branch():
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = flash_attention.fake_launches_by_shape.get("fwd/16/causal", 0)
    launches = flash_attention.launches
    with FakeTensorMode():
        q, k, v = (torch.empty(s) for s in ((2, 32, 4, 16), (2, 32, 2, 16),
                                            (2, 32, 2, 16)))
        _, rec = hlo.record(flash_attention, q, k, v)
        out, lse = flash_attention(q, k, v)
    assert out.shape == (2, 32, 4, 16) and lse.shape == (2, 4, 32)
    assert lse.dtype == torch.float32
    assert [op.name for op in rec if op.kind == "kernel"] == [
        "kernel.flash_attention_fwd"]
    assert flash_attention.fake_launches_by_shape["fwd/16/causal"] == before + 2
    assert flash_attention.launches == launches


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--device", "cpu", "--no-save", *argv], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)


def test_the_command_line_dry_runs_a_cell():
    out = _cli("--arch", "yi-6b", "--shape", "decode_32k", "--preset",
               "smoke", "--mesh", "2x2")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["mesh"] == "2x2" and result["n_chips"] == 4
    assert result["memory"]["alias_bytes"] > 0          # the caches
    assert result["walker"]["flops_per_device"] > 0
    assert set(result["schedule"]) >= {"exposed_fraction", "n_collectives"}
    assert "roofline:" in out.stdout


def test_a_family_without_a_sharded_path_records_ok_false():
    # every family now has a sharded path; what the name still checks is
    # that a cell that raises (here: an arch that does not exist) exits 1
    # and records ok: false with its error
    out = _cli("--arch", "no-such-arch", "--shape", "train_4k")
    assert out.returncode == 1
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["ok"] is False
    assert "no-such-arch" in result["error"]


def test_modeled_schedule_flags_a_collective_with_compute_before_its_wait():
    """Compute between an issue and its wait overlaps the collective;
    compute after the wait does not; a synchronous collective never
    overlaps. Costs: compute max(FLOPs / peak, bytes / HBM), a collective
    its wire bytes / link."""
    from repro_torch.core.device_timeline import (modeled_schedule,
                                                  serialization_report)
    from repro_torch.core.roofline import HW

    def op(i, kind, flops=0.0, nbytes=0, opcode=None, done=None, start=None):
        c = None if opcode is None else hlo.CollectiveOp(
            f"%{i}", opcode, done != i, 4096, 4096, 4, 1, "")
        return hlo.RecordedOp(i, "x", kind, [], [], flops=flops, bytes=nbytes,
                              collective=c, done=done, start=start)

    rec = hlo.Recording()
    rec.ops = [op(0, "collective", opcode="all-reduce", done=2),
               op(1, "op", flops=2e12),
               op(2, "done", start=0),
               op(3, "collective", opcode="all-gather", done=4),
               op(4, "done", start=3),
               op(5, "op", nbytes=int(3.35e9)),
               op(6, "collective", opcode="all-reduce", done=6)]
    segs = modeled_schedule(rec)
    assert [(s.kind, s.overlapped) for s in segs] == [
        ("collective", True), ("compute", False), ("collective", False),
        ("compute", False), ("collective", False)]
    assert segs[1].t_cost == 2e12 / HW["peak_flops_bf16"]
    assert segs[3].t_cost == 3.35e9 / HW["hbm_bw"]
    assert segs[0].t_cost == 2 * 4096 * 3 / 4 / HW["link_bw"]
    rep = serialization_report(segs)
    assert rep.n_collectives == 3 and rep.n_overlapped == 1
