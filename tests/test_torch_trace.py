"""The port's trace package (``repro_torch.trace``) against the JAX
package's (``repro.trace``).

Every committed corpus trace (``tests/corpus``) and the sparse-neighbors
golden replay, on both replay paths, to the reference's non-time counters,
phase statistics and detector finding kinds; the trace differ gives the
reference's deltas and flags on the same replays; and a halo run of the
port on 8 ranks records, through ``record_collectives``, the trace that
the JAX halo program records on 8 host devices (one dispatch each: the
reference's jitted segments feed the fabric once per compile), equal once
the measured times are dropped.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro import trace as jax_trace
from repro.core import analyses as jax_analyses
from repro_torch import trace
from repro_torch.comm.halo import HaloProgram
from repro_torch.comm.mesh import Mesh
from repro_torch.comm.progress import ProgressEngine
from repro_torch.core import analyses

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CORPUS = os.path.join(HERE, "corpus")
GOLDEN = os.path.join(HERE, "goldens", "sparse_neighbors_fifo_smoke.jsonl")
with open(os.path.join(CORPUS, "manifest.json"), encoding="utf-8") as _f:
    ENTRIES = [(os.path.join(CORPUS, e["file"]), e["engine_mode"], e["id"])
               for e in json.load(_f)["entries"]]
TRACES = ENTRIES + [(GOLDEN, "fifo", "golden_sparse_neighbors_fifo_smoke")]


def _timeless(stats):
    """Counter stats without the measured (``*_ns``) counters."""
    return {name: (s.kind, s.count, s.total, s.vmin, s.vmax,
                   sorted(s.bins.items()))
            for name, s in stats.items() if not name.endswith("_ns")}


def _summary(res, detectors):
    return {
        "mode": (res.mode, res.progress_mode),
        "n_ops": res.n_ops,
        "divergences": len(res.divergences),
        "totals": _timeless(res.totals()),
        "phases": [(p.index, p.label, p.op, p.attrs,
                    {rank: _timeless(st) for rank, st in p.stats.items()})
                   for p in res.phases],
        "findings": sorted({f.kind for f in detectors.analyze_all(
            res.events)}),
    }


@pytest.mark.parametrize("checked", [False, True],
                         ids=["batched", "checked"])
@pytest.mark.parametrize("path,mode", [t[:2] for t in TRACES],
                         ids=[t[2] for t in TRACES])
def test_trace_replays_as_the_reference(path, mode, checked):
    got = trace.replay(path, mode=mode, check_matches=checked)
    want = jax_trace.replay(path, mode=mode, check_matches=checked)
    assert _summary(got, analyses) == _summary(want, jax_analyses)
    assert got.n_ops > 0


def _delta(d):
    return (d.index, d.label, d.op, d.rank, d.depth_mean, d.depth_count,
            d.umq_len_mean, d.umq_len_max)


@pytest.mark.parametrize("path", [t[0] for t in ENTRIES],
                         ids=[t[2] for t in ENTRIES])
def test_trace_diff_matches_the_reference(path):
    """Each what-if engine against the healthy one: the same (phase,
    rank) deltas (their measured search time aside) and the same flags
    (severities are queue-entry counts, deterministic)."""
    for mod in ("linear", "leaky_umq"):
        got = trace.diff(trace.replay(path, mode="binned"),
                         trace.replay(path, mode=mod))
        want = jax_trace.diff(jax_trace.replay(path, mode="binned"),
                              jax_trace.replay(path, mode=mod))
        assert [_delta(d) for d in got.deltas] == [
            _delta(d) for d in want.deltas]
        assert [(f.kind, f.severity) for f in got.flags()] == [
            (f.kind, f.severity) for f in want.flags()]


# the reference's halo program, recorded on 8 host devices
JAX_RECORD = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.comm.halo import HaloProgram
    from repro.core.compat import make_mesh
    from repro.trace import record_collectives

    path, box = sys.argv[1], int(sys.argv[2])
    mesh = make_mesh((2, 2, 2), ("x", "y", "z"))
    u = np.random.default_rng(0).standard_normal((2 * box,) * 3)
    ug = jax.device_put(jnp.asarray(u, jnp.float32),
                        NamedSharding(mesh, P("x", "y", "z")))
    with record_collectives(path, mode="binned", wall_clock=False,
                            meta={"app": "halo", "box": box}):
        jax.block_until_ready(HaloProgram(mesh, explicit=True).run(ug,
                                                                   steps=1))
""")
TIME_KEYS = ("ts", "t_wall", "dur", "wait")


def _records(path):
    """The expanded records without measured times; the final snapshot's
    measured counters by count only."""
    _, records = trace.read_trace(path)
    out = []
    for rec in records:
        rec = {k: v for k, v in rec.items() if k not in TIME_KEYS}
        if rec["t"] == "snap":
            rec = {k: ({rank: {name: (st if not name.endswith("_ns")
                                      else st.get("count"))
                               for name, st in per.items()}
                        for rank, per in v.items()}
                       if isinstance(v, dict) else v)
                   for k, v in rec.items()}
        out.append(rec)
    return out


def test_halo_app_records_the_reference_trace(tmp_path):
    box = 4
    ref = str(tmp_path / "jax.jsonl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", JAX_RECORD, ref, str(box)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]

    mine = str(tmp_path / "port.jsonl")
    mesh = Mesh((2, 2, 2), ("x", "y", "z"))
    u = mesh.shard(torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2 * box,) * 3)).to(torch.float32))
    with trace.record_collectives(mine, mode="binned", wall_clock=False,
                                  meta={"app": "halo", "box": box}):
        HaloProgram(mesh, explicit=True).run(u, steps=1)
    got, want = _records(mine), _records(ref)
    assert got == want
    # 6 faces, each a permute over a 2-rank ring: 12 messages a step
    assert sum(r["t"] == "arr" for r in got) == 12


def test_recorded_halo_run_replays_to_its_snapshot(tmp_path):
    """Record one explicit_overlap-style run (the progress engine's lane
    in the same trace) and replay it under both queue disciplines: no
    divergent match, every non-time counter of every rank equal to the
    record-time snapshot, and no lock contention in the incoming
    discipline's model."""
    path = str(tmp_path / "halo.jsonl")
    mesh = Mesh((2, 2, 2), ("x", "y", "z"))
    u = mesh.shard(torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 8, 8))).to(torch.float32))
    with trace.record_collectives(path, mode="binned") as fab:
        engine = ProgressEngine("incoming", trace=fab.trace)
        try:
            HaloProgram(mesh, explicit=True).run(u, steps=2, engine=engine)
        finally:
            engine.shutdown()
    for disc in ("shared", "incoming"):
        res = trace.replay(path, progress_mode=disc)
        assert not res.divergences and res.pe_records
        rec, got = res.recorded_stats, res.totals_by_rank()
        assert sorted(rec) == sorted(got) == [0, 1]
        for rank in rec:
            assert _timeless(rec[rank]) == _timeless(got[rank])
        if disc == "incoming":
            assert analyses.contention(res.progress_events) == []
