"""The port's timeline layer against the JAX package's: the device-timeline
lanes and serialization report, the roofline, model FLOPs and parameter
counts, and the reader of ``torch.profiler``'s Kineto traces; and the FLOPs
that ``repro_torch.core.cost`` counts over a train step on the CPU.

The copied functions take the same inputs, made from a seeded numpy
generator, and must give the reference's outputs exactly. The Kineto
reader has no counterpart (the reference models its timeline from HLO
text) and is held to a hand-built trace whose segments are known.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.core import counters as jax_counters
from repro.core import device_timeline as jax_dt
from repro.core import hlo as jax_hlo
from repro.core import roofline as jax_roofline
from repro.launch.flops import model_flops as jax_model_flops
from repro.models.model import active_param_count as jax_active
from repro.models.model import param_count as jax_param_count
from repro_torch.configs import archs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import cost, counters, device_timeline, regions
from repro_torch.core import roofline
from repro_torch.launch import halo as halo_app
from repro_torch.launch.flops import matmul_param_count, model_flops
from repro_torch.models.model import Model, active_param_count, param_count
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

SEEDS = [0, 1, 2]


def _segments(seed, mod):
    """A seeded schedule of compute and collective segments, as ``mod``'s
    ``Segment``s."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(4, 12))):
        coll = bool(rng.random() < 0.5)
        out.append(mod.Segment(
            name=f"{'all-gather' if coll else 'fusion'}.{i}",
            kind="collective" if coll else "compute",
            t_cost=float(rng.random() * 1e-3),
            overlapped=bool(coll and rng.random() < 0.5)))
    return out


def _stats(seed, mod):
    """Seeded matching-engine counter stats, as ``mod``'s ``CounterStat``s."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    for name, kind in (("match.prq.search_ns", "counter"),
                       ("match.umq.search_ns", "counter"),
                       ("match.prq.traversal_depth", "histogram"),
                       ("match.umq.length", "histogram")):
        n = int(rng.integers(1, 50))
        vals = rng.random(n) * 1e5
        st = mod.CounterStat(name=name, kind=kind, count=n,
                             total=float(vals.sum()), vmin=float(vals.min()),
                             vmax=float(vals.max()))
        out[name] = st
    return out


def _fields(events):
    return [dataclasses.astuple(e) for e in events]


@pytest.mark.parametrize("seed", SEEDS)
def test_serialization_report_matches_the_reference(seed):
    got = device_timeline.serialization_report(
        _segments(seed, device_timeline))
    want = jax_dt.serialization_report(_segments(seed, jax_dt))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.exposed_fraction == want.exposed_fraction
    assert got.modeled_step_time == want.modeled_step_time
    assert got.summary() == want.summary()


@pytest.mark.parametrize("seed", SEEDS)
def test_to_events_matches_the_reference(seed):
    got = device_timeline.to_events(_segments(seed, device_timeline), pid=3)
    want = jax_dt.to_events(_segments(seed, jax_dt), pid=3)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("seed", SEEDS)
def test_overlay_match_lane_matches_the_reference(seed):
    events = device_timeline.to_events(_segments(seed, device_timeline))
    jevents = jax_dt.to_events(_segments(seed, jax_dt))
    got = device_timeline.overlay_match_lane(events, _stats(seed, counters))
    want = jax_dt.overlay_match_lane(jevents, _stats(seed, jax_counters))
    assert _fields(got) == _fields(want)
    assert device_timeline.MATCH_TID == jax_dt.MATCH_TID
    assert device_timeline.overlay_match_lane(events, {}) == []


@pytest.mark.parametrize("seed", SEEDS)
def test_roofline_matches_the_reference_on_its_constants(seed):
    """The port's Roofline on the reference's TPU constants (its link
    term renamed ``link_bw``) gives the reference's numbers exactly."""
    rng = np.random.default_rng(seed)
    kw = dict(flops=float(rng.random() * 1e15),
              hbm_bytes=float(rng.random() * 1e11),
              wire_bytes=float(rng.random() * 1e9),
              n_chips=int(rng.integers(1, 9)),
              model_flops=float(rng.random() * 1e15),
              match_s=float(rng.random() * 1e-3) if seed else None)
    hw = dict(jax_roofline.HW)
    want = jax_roofline.Roofline(**kw, hw=hw)
    got = roofline.Roofline(**kw, hw=dict(hw, link_bw=hw["ici_bw"]))
    assert got.to_dict() == want.to_dict()
    assert got.summary() == want.summary()
    stats = _stats(seed, counters)
    assert roofline.match_seconds(stats) == jax_roofline.match_seconds(
        _stats(seed, jax_counters))


def test_roofline_defaults_to_the_h100_data_sheet():
    assert roofline.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                           "link_bw": 450e9, "hbm_gb": 80.0}
    r = roofline.Roofline(flops=989e12, hbm_bytes=0, wire_bytes=450e9,
                          n_chips=1)
    assert r.t_compute == 1.0 and r.t_collective == 1.0


@pytest.mark.parametrize("arch", sorted(jax_archs.ARCHS))
def test_model_flops_and_param_counts_match_the_reference(arch):
    for preset in ("full", "smoke"):
        jcfg = jax_archs.get_config(arch, preset)
        cfg = archs.get_config(arch, preset)
        assert param_count(cfg) == jax_param_count(jcfg)
        assert active_param_count(cfg) == jax_active(jcfg)
        for name in JAX_SHAPES:
            assert model_flops(cfg, SHAPES[name]) == jax_model_flops(
                jcfg, JAX_SHAPES[name]), (preset, name)


@pytest.mark.parametrize("opcode", sorted(cost.OPCODES.values()))
def test_wire_bytes_match_the_reference(opcode):
    for g in (1, 2, 3, 8):
        for nbytes in (0, 4, 4096, 12345):
            op = jax_hlo.CollectiveOp(
                name="x", opcode=opcode, is_async=False,
                operand_bytes=nbytes,
                result_bytes=nbytes * g if opcode == "all-gather" else nbytes,
                group_size=g, num_groups=1, line="")
            assert cost.wire_bytes(opcode, nbytes, g) == op.wire_bytes


# ---------------------------------------------------------------- the reader

MAIN, PROGRESS = 100, 200


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _kineto():
    """A profiled window of 100 us: kernels on stream 7 (the caller's; the
    matmul launched through the driver API, as cuBLAS launches) and
    on stream 13 (a side stream: launched from the progress engine's
    thread, which has no host spans), a device copy launched inside a
    ``comm_ppermute_x`` span, a fill; one host region, and an aten op
    that waits for the card."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "python"}},
        _x("user_annotation", device_timeline.WINDOW, 0, 100, MAIN),
        _x("user_annotation", "serve/decode_step", 0, 9, MAIN),
        _x("cuda_driver", "cuLaunchKernelEx", 5, 1, MAIN, correlation=2),
        _x("kernel", "sm90_xmma_gemm_bf16", 10, 20, 7, stream=7,
           correlation=2),
        _x("user_annotation", "comm_ppermute_x", 31, 2, MAIN),
        _x("cuda_runtime", "cudaMemcpyAsync", 32, 0.5, MAIN, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 35, 5, 7,
           stream=7, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 34, 0.5, MAIN, correlation=4),
        _x("kernel", "void flash_fwd_wgmma_kernel<128>(...)", 40, 20, 7,
           stream=7, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 36, 0.5, PROGRESS,
           correlation=5),
        _x("kernel", "index_copy_kernel", 45, 25, 13, stream=13,
           correlation=5),
        _x("cuda_runtime", "cudaMemsetAsync", 70, 0.5, MAIN, correlation=6),
        _x("gpu_memset", "Memset (Device)", 75, 5, 7, stream=7,
           correlation=6),
        _x("cpu_op", "aten::_local_scalar_dense", 84, 12, MAIN),
        _x("gpu_user_annotation", "comm_ppermute_x", 35, 5, 7),
    ]
    return {"traceEvents": ev}


def test_kineto_reader_gives_the_segments():
    segs = device_timeline.extract_schedule(_kineto())
    want = [("compute", "compute", 20e-6, False),
            ("comm_ppermute_x", "collective", 5e-6, False),
            ("compute", "compute", 20e-6, False),
            ("index_copy_kernel", "collective", 15e-6, True),
            ("index_copy_kernel", "collective", 10e-6, False),
            ("compute", "compute", 5e-6, False)]
    got = [(s.name, s.kind, s.t_cost, s.overlapped) for s in segs]
    assert [g[:2] + g[3:] for g in got] == [w[:2] + w[3:] for w in want]
    assert [g[2] for g in got] == pytest.approx([w[2] for w in want])
    rep = device_timeline.serialization_report(segs)
    assert rep.t_compute == pytest.approx(45e-6)
    assert rep.t_collective_total == pytest.approx(30e-6)
    assert rep.t_collective_exposed == pytest.approx(15e-6)
    assert rep.exposed_fraction == pytest.approx(0.5)
    assert (rep.n_collectives, rep.n_overlapped) == (3, 1)
    assert device_timeline.side_streams(_kineto()) == [13]


def test_kineto_reader_device_report():
    rep = device_timeline.device_report(_kineto(), top=3, gaps=2,
                                        phases=("serve/decode_step",))
    assert rep["window_ms"] == pytest.approx(0.1)
    assert rep["busy_ms"] == pytest.approx(0.06)
    assert rep["idle_share"] == pytest.approx(0.4)
    assert rep["events"] == 5
    assert [k["name"] for k in rep["kernels"]] == [
        "index_copy_kernel", "sm90_xmma_gemm_bf16",
        "void flash_fwd_wgmma_kernel<128>(...)"]
    assert [(round(g["ms"], 6), round(g["at_ms"], 6), g["host"])
            for g in rep["idle_gaps"]] == [(0.02, 0.08,
                                            "aten::_local_scalar_dense"),
                                           (0.01, 0.0, "serve/decode_step")]
    assert rep["streams"]["13"] == {"ms": pytest.approx(0.025), "events": 1,
                                    "collective_events": 1}
    assert rep["streams"]["7"]["collective_events"] == 1
    assert rep["by_phase"]["serve/decode_step"] == {
        "matmul": pytest.approx(0.02)}
    assert rep["by_phase"][""]["attention"] == pytest.approx(0.02)
    assert device_timeline.launches_by_symbol(
        _kineto(), ["flash_fwd_wgmma_kernel", "selective_scan_kernel"]) == {
            "flash_fwd_wgmma_kernel": 1, "selective_scan_kernel": 0}


def test_regions_are_profiler_spans_only_while_a_profiler_runs():
    from torch.profiler import ProfilerActivity, profile

    with regions.annotate("outside", category="app"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with regions.annotate("train/step", category="app"):
            torch.ones(2) + 1
    names = [e.name for e in prof.events()]
    assert "train/step" in names and "outside" not in names


def test_device_timeline_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        device_timeline.profile(lambda: None)
    with pytest.raises(ValueError, match="--device cuda"):
        halo_app.main(["--device", "cpu", "--box", "4", "--steps", "1",
                       "--runs", "1", "--emit-device-timeline"])


# ---------------------------------------------------------------- cost.py

def test_cost_of_a_cpu_train_step_against_model_flops():
    """The smoke yi-6b train step (f32, full remat) on the CPU, where the
    attention runs its plain version, which the tally counts as the
    kernels it stands in for (forward twice a layer, dq and dk/dv once:
    their work from their shapes), not by its own matmuls. Every
    parameter matmul is an ``mm``: forward (2N), backward (4N), and the
    remat's second forward, which stops before each layer's last matmul
    (the MLP's down projection: PyTorch's checkpoint ends the recompute
    once every saved tensor is back) while the chunked loss recomputes its
    lm-head product in full. The counted FLOPs exceed the model's by that
    recompute."""
    cfg = dataclasses.replace(archs.get_config("yi-6b", "smoke"),
                              dtype="float32")
    model = Model(cfg, torch.device("cpu"), trainable=True).init_weights(0)
    B, T = 2, 32
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state = adamw.init_state(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.AdamWConfig())
    _, tally = cost.step_cost(step, model, state, batch)

    tokens, E, Vp = B * T, cfg.d_model, cfg.padded_vocab_size
    norms = (2 * cfg.n_layers + 1) * E
    head = E * Vp
    layers = matmul_param_count(cfg) - head - norms
    last = cfg.n_layers * E * cfg.d_ff          # each layer's down projection
    assert tally.flops_by_op["aten.mm"] == (
        8 * layers * tokens - 2 * last * tokens + 8 * head * tokens)
    mf = model_flops(cfg, ShapeConfig("t", T, B, "train"))
    assert tally.flops > mf
    r = roofline.Roofline(flops=tally.flops, hbm_bytes=tally.bytes,
                          wire_bytes=0, n_chips=1, model_flops=mf)
    assert 0.5 < r.useful_flops_fraction < 1.0
    L = cfg.n_layers
    assert {k: v["launches"] for k, v in tally.kernels.items()} == {
        "flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
        "flash_attention_bwd_dkv": L}
    assert tally.bytes > 0
    assert not cost.counting()


def test_kernel_wrappers_add_their_work_only_inside_a_tally():
    cost.add_kernel("outside", 1.0, 2.0)            # no tally open: dropped
    with cost.count_cost() as tally:
        cost.add_kernel("flash_attention_fwd", *cost.attention_work(
            2, 64, 64, 4, 2, 16, True, None, 2))
        cost.add_kernel("selective_scan", 10.0, 20.0)
    fwd = tally.kernels["flash_attention_fwd"]
    assert fwd["launches"] == 1
    assert fwd["flops"] == 4 * 16 * 2 * 4 * (64 * 65 // 2)
    assert tally.flops == fwd["flops"] + 10.0
    assert set(tally.kernels) == {"flash_attention_fwd", "selective_scan"}


def test_collective_stats_from_the_halo_regions():
    """One halo step on 8 ranks: 6 face permutes (3 axes x 2 directions)
    of one rank's face, 4 x 4 f32 at box 4."""
    from repro_torch.comm.halo import HaloProgram
    from repro_torch.comm.mesh import Mesh
    from repro_torch.core.collector import reset_global_collector

    mesh = Mesh((2, 2, 2), ("x", "y", "z"))
    u = mesh.shard(torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8, 8)).astype(np.float32)))
    col = reset_global_collector()
    HaloProgram(mesh, explicit=True).run(u, steps=1)
    st = cost.collective_stats(col.drain(), mesh.shape)
    assert st["count"] == 6 and set(st["by_opcode"]) == {"collective-permute"}
    assert st["operand_bytes"] == st["wire_bytes"] == 6 * 4 * 4 * 4
