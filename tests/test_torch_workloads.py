"""The port's scenario gallery and benches (``repro_torch.workloads``)
against the JAX package's (``repro.workloads``).

Every cell of the committed hot-path goldens (the reference's traces,
finding kinds and sweep rows) through the port's ``run_scenario``, byte
for byte; the committed golden trace file; the smoke sweep against the
committed ``scenario_baseline_smoke.json`` and against the reference's
own sweep; the live progress engine under both disciplines; the
deterministic fields of the hot-path, replay and telemetry benches
(their times and ratios are host-CPU numbers and are not compared); and
importing the four host packages pulls in neither ``torch`` nor ``jax``.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import pytest

from repro import workloads as jax_workloads
from repro.workloads import hotpath as jax_hotpath
from repro.workloads import replaybench as jax_replaybench
from repro.workloads import telemetry as jax_telbench
from repro_torch import workloads
from repro_torch.faults import composite_names
from repro_torch.workloads import hotpath, replaybench
from repro_torch.workloads import telemetry as telbench

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_DIR = os.path.join(HERE, "goldens")
with open(os.path.join(GOLDEN_DIR, "hotpath_goldens.json"),
          encoding="utf-8") as _f:
    GOLDENS = json.load(_f)
CELLS = sorted(GOLDENS["cells"].items())
BASELINE = os.path.join(REPO, "benchmarks", "baselines",
                        "scenario_baseline_smoke.json")


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _timeless(payload):
    """A sweep payload without its measured ``us_per_op`` columns."""
    out = json.loads(json.dumps(payload))
    for entry in out["scenarios"].values():
        for cells in (entry["cells"], entry.get("fault_cells", {})):
            for cell in cells.values():
                cell.pop("us_per_op")
    return out


def test_golden_cells_cover_the_gallery_and_every_engine_mode():
    assert len(CELLS) == 28
    names = {k.split("|")[0] for k, _ in CELLS}
    assert names <= set(workloads.names())
    assert {k.split("|")[1] for k, _ in CELLS} == set(GOLDENS["engine_modes"])


@pytest.mark.parametrize("key,want", CELLS, ids=[k for k, _ in CELLS])
def test_golden_cell_is_reproduced(tmp_path, key, want):
    name, mode, size = key.split("|")
    path = str(tmp_path / "t.jsonl")
    run = workloads.run_scenario(name, engine_mode=mode,
                                 seed=GOLDENS["seed"], size=size,
                                 trace_path=path, wall_clock=False,
                                 trace_schema=GOLDENS.get("trace_schema", 2))
    assert _sha256(path) == want["sha256"]
    assert run.finding_kinds == want["findings"]
    got = {k: v for k, v in run.row().items() if k != "us_per_op"}
    exp = {k: v for k, v in want["row"].items() if k != "us_per_op"}
    assert got == exp


def test_committed_golden_trace_is_reproduced(tmp_path):
    name, mode, size = GOLDENS["golden_trace"]["cell"].split("|")
    path = str(tmp_path / "t.jsonl")
    workloads.run_scenario(name, engine_mode=mode, seed=GOLDENS["seed"],
                           size=size, trace_path=path, wall_clock=False,
                           trace_schema=GOLDENS.get("trace_schema", 2))
    ref = os.path.join(GOLDEN_DIR, GOLDENS["golden_trace"]["file"])
    with open(path, "rb") as got, open(ref, "rb") as want:
        assert got.read() == want.read()


def _declared(sc):
    return {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)
            if f.name != "drive"}


def test_gallery_is_the_reference():
    assert workloads.names() == jax_workloads.names()
    assert len(workloads.names()) == 12
    for name in workloads.names():
        assert _declared(workloads.get(name)) == \
            _declared(jax_workloads.get(name)), name
    assert workloads.DEFECT_DETECTOR == jax_workloads.DEFECT_DETECTOR
    assert workloads.FAULT_DETECTOR == jax_workloads.FAULT_DETECTOR


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "fault_axis"])
def test_smoke_sweep_passes_against_the_committed_baseline(faults):
    kinds = (list(workloads.FAULT_KINDS) + list(composite_names())
             if faults else False)
    got = workloads.sweep(size="smoke", seed=0, faults=kinds)
    with open(BASELINE, encoding="utf-8") as f:
        baseline = json.load(f)
    assert workloads.check(got) == []
    assert workloads.compare_to_baseline(got, baseline) == []
    want = jax_workloads.sweep(size="smoke", seed=0, faults=kinds)
    assert _timeless(got) == _timeless(want)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("mode", ["fifo", "linear", "leaky_umq"])
def test_elastic_ranks_trace_is_the_reference(tmp_path, mode, size):
    # the (data, model) factorization is written inline in the port
    paths = [str(tmp_path / f"{who}.jsonl") for who in ("port", "ref")]
    for run_scenario, path in ((workloads.run_scenario, paths[0]),
                               (jax_workloads.run_scenario, paths[1])):
        run_scenario("elastic_ranks", engine_mode=mode, seed=0, size=size,
                     trace_path=path, wall_clock=False, trace_schema=3)
    assert _sha256(paths[0]) == _sha256(paths[1])


@pytest.mark.parametrize("progress_mode", ["shared", "incoming"])
def test_live_progress_records_under_each_discipline(progress_mode):
    recs = workloads.live_progress_records(progress_mode, n_requests=8,
                                           quantum_ns=20_000)
    evs = [r["ev"] for r in recs]
    assert evs.count("submit") == 8 and evs.count("proc") == 8
    assert all(r["t"] == "pe" for r in recs)
    live = workloads.run_scenario("request_reply", size="smoke",
                                  progress_mode=progress_mode,
                                  live_progress=True)
    modeled = workloads.run_scenario("request_reply", size="smoke",
                                     progress_mode=progress_mode)
    for m in ("n_ops", "depth_mean", "depth_max", "umq_mean", "umq_max"):
        assert getattr(live, m) == getattr(modeled, m), m


@pytest.mark.parametrize("mode", hotpath.HOTPATH_MODES)
def test_hotpath_cell_counts_are_the_reference(tmp_path, mode):
    fields = ("n_ops", "n_trace_records", "n_drain_deltas")
    got = hotpath.measure_cell("halo3d", mode, size="smoke", repeats=1,
                               scratch_dir=str(tmp_path))
    want = jax_hotpath.measure_cell("halo3d", mode, size="smoke", repeats=1,
                                    scratch_dir=str(tmp_path))
    assert {k: got[k] for k in fields} == {k: want[k] for k in fields}
    assert got["n_ops"] > 0


def test_replay_bench_equivalence_and_counts(tmp_path):
    v2, v3 = replaybench.record_pair("master_worker", size="smoke",
                                     scratch_dir=str(tmp_path))
    assert replaybench.equivalence_failures("master_worker", v2, v3) == []
    got = replaybench.measure_cell("master_worker", size="smoke", repeats=1,
                                   paths=(v2, v3))
    want = jax_replaybench.measure_cell("master_worker", size="smoke",
                                        repeats=1, paths=(v2, v3))
    assert got["n_ops"] == want["n_ops"] > 0


def test_telemetry_bench_keeps_every_delta():
    got = telbench.measure_overhead_cell("unexpected_storm", repeats=1,
                                         drives=2)
    want = jax_telbench.measure_overhead_cell("unexpected_storm", repeats=1,
                                              drives=2)
    assert (got["n_ops"], got["drives"]) == (want["n_ops"], want["drives"])
    live = telbench.live_finding_check()
    # the final poll at stop adopts what is left, so the flood is always
    # found by the end; whether it showed mid-run depends on host timing
    assert live["pending_after"] == 0 and live["live_findings"] >= 1


@pytest.mark.parametrize("pkg", ["workloads", "faults", "telemetry",
                                 "corpus"])
def test_host_package_imports_neither_torch_nor_jax(pkg):
    code = (f"import sys, repro_torch.{pkg}; "
            "print(sorted(m for m in ('torch', 'jax', 'repro') "
            "if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"
