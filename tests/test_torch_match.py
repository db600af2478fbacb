"""The port's message-matching engine, counters and defect models against
the JAX package's, on the same op sequences.

The engine is a framework-neutral copy, so the same ops must give the
same matches and the same counters. Counters that hold times (``*_ns``:
sampled search latencies) cannot agree to the byte; of those only the
number of samples is compared. Every other counter (counts, depths,
lengths, bytes, tags) must agree exactly, in every engine mode, the
seeded defects (``linear``, ``leaky_umq``) included, and so must the
findings the analyses draw from them.
"""
import numpy as np
import pytest

from repro.core import analyses as jx_analyses
from repro.core.counters import CounterRegistry as JxRegistry
from repro.match import ANY_SOURCE as JX_ANY_SOURCE
from repro.match import ANY_TAG as JX_ANY_TAG
from repro.match import MODES as JX_MODES
from repro.match import Fabric as JxFabric
from repro.match import MatchEngine as JxEngine
from repro.match.legacy import LegacyFabric as JxLegacyFabric
from repro_torch.comm import patterns as pt_patterns
from repro_torch.core import analyses as pt_analyses
from repro_torch.core.counters import CounterRegistry as PtRegistry
from repro_torch.match import ANY_SOURCE, ANY_TAG, MODES
from repro_torch.match import Fabric as PtFabric
from repro_torch.match import MatchEngine as PtEngine
from repro_torch.match.legacy import LegacyFabric as PtLegacyFabric

JX = dict(engine=JxEngine, fabric=JxFabric, legacy=JxLegacyFabric,
          registry=JxRegistry, any_source=JX_ANY_SOURCE, any_tag=JX_ANY_TAG)
PT = dict(engine=PtEngine, fabric=PtFabric, legacy=PtLegacyFabric,
          registry=PtRegistry, any_source=ANY_SOURCE, any_tag=ANY_TAG)


def _stats(stats):
    """Counter name -> comparable statistics; of a time counter only its
    number of samples."""
    out = {}
    for name, s in stats.items():
        if name.endswith("_ns"):
            out[name] = (s.kind, s.count)
        else:
            out[name] = (s.kind, s.count, s.total, s.vmin, s.vmax,
                         dict(sorted(s.bins.items())))
    return out


def _ops(seed, n=600):
    """A random legal post/arrive stream (wildcards, two communicators):
    never more arrivals than posted receives."""
    rng = np.random.default_rng(seed)
    ops, balance = [], 0
    for _ in range(n):
        comm = int(rng.integers(0, 2))
        if balance > 0 and rng.random() < 0.5:
            ops.append(("arrive", int(rng.integers(0, 4)),
                        int(rng.integers(0, 6)), comm))
            balance -= 1
        else:
            src = None if rng.random() < 0.3 else int(rng.integers(0, 4))
            tag = None if rng.random() < 0.3 else int(rng.integers(0, 6))
            ops.append(("post", src, tag, comm))
            balance += 1
    return ops


def _run_engine(pkg, mode, ops):
    reg = pkg["registry"]()
    eng = pkg["engine"](mode=mode, registry=reg)
    recvs = []
    for op, a, b, c in ops:
        if op == "post":
            recvs.append(eng.post_recv(
                src=pkg["any_source"] if a is None else a,
                tag=pkg["any_tag"] if b is None else b, comm=c))
        else:
            eng.arrive(src=a, tag=b, comm=c)
    pairs = [(r.seq, r.message.seq) for r in recvs if r.completed]
    return pairs, _stats(reg.drain())


def test_modes_are_the_reference_modes():
    assert MODES == JX_MODES


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_and_counters_agree(mode, seed):
    ops = _ops(seed)
    jx_pairs, jx_stats = _run_engine(JX, mode, ops)
    pt_pairs, pt_stats = _run_engine(PT, mode, ops)
    assert len(jx_pairs) > 100
    assert pt_pairs == jx_pairs
    assert pt_stats == jx_stats


def _drive_fabric(pkg, mode, kind="fabric"):
    """Every collective decomposition of the fabric, then a deep tag scan
    on rank 0 (the linear-search defect's trigger)."""
    reg = pkg["registry"]()
    fab = pkg[kind](mode=mode, registry=reg)
    for n in (2, 8):
        fab.all_reduce(n, nbytes=1 << 12)
        fab.all_gather(n, nbytes=4096)
        fab.reduce_scatter(n, nbytes=4096)
        fab.all_to_all(n, nbytes=4096)
    for ax, direction, perm, tag in pt_patterns.halo_shifts(8):
        fab.ppermute(perm, nbytes=1 << 10, tag=tag)
    eng = fab.engine(0)
    for t in range(64):
        eng.post_recv(src=1, tag=10_000 + t)
    for t in reversed(range(64)):
        eng.arrive(src=1, tag=10_000 + t)
    return fab.outstanding(), _stats(reg.drain())


@pytest.mark.parametrize("kind", ["fabric", "legacy"])
@pytest.mark.parametrize("mode", MODES)
def test_fabric_collectives_give_the_same_counters(mode, kind):
    jx = _drive_fabric(JX, mode, kind)
    pt = _drive_fabric(PT, mode, kind)
    assert pt == jx
    assert pt[1]["match.expected"][1] > 0


def _workload(pkg, mode, rounds=20):
    """tests/test_match.py's detector workload: ring all-reduces plus a
    reversed 256-deep tag scan on rank 0, as counter snapshot events."""
    reg = pkg["registry"]()
    fab = pkg["fabric"](mode=mode, registry=reg)
    for _ in range(rounds):
        fab.all_reduce(16, nbytes=1 << 16)
        eng = fab.engine(0)
        for t in range(256):
            eng.post_recv(src=1, tag=10_000 + t)
        for t in reversed(range(256)):
            eng.arrive(src=1, tag=10_000 + t)
    return reg.snapshot_events()


def _counter_events(evs):
    """Snapshot events without their time counters."""
    return sorted((e.name, e.pid, tuple(sorted(
        (k, v) for k, v in (e.attrs or {}).items() if k != "bins")))
        for e in evs if not e.name.endswith("_ns"))


@pytest.mark.parametrize("mode", MODES)
def test_detector_workload_snapshots_and_findings_agree(mode):
    jx_evs, pt_evs = _workload(JX, mode), _workload(PT, mode)
    assert _counter_events(pt_evs) == _counter_events(jx_evs)
    jx = jx_analyses.analyze_all(jx_evs)
    pt = pt_analyses.analyze_all(pt_evs)
    # severities (and so the order) of findings come from sampled search
    # times: compare which rank was flagged for what
    assert (sorted((f.kind, f.pid) for f in pt)
            == sorted((f.kind, f.pid) for f in jx))
    kinds = {f.kind for f in pt}
    if mode == "linear":
        assert "long_traversal" in kinds
    if mode == "leaky_umq":
        assert "umq_flood" in kinds
    if mode == "binned":
        assert not kinds & {"long_traversal", "umq_flood"}


@pytest.mark.parametrize("mode", MODES)
def test_lane_detectors_agree(mode):
    jx_reg, pt_reg = JxRegistry(), PtRegistry()
    for reg, fabric in ((jx_reg, JxFabric), (pt_reg, PtFabric)):
        fab = fabric(mode=mode, registry=reg)
        for _ in range(8):
            fab.all_reduce(8, nbytes=1 << 14)
            fab.ppermute(pt_patterns.ring_perm(8, 1), nbytes=64, tag=3)
    jx_lanes, pt_lanes = jx_reg.drain_lanes(), pt_reg.drain_lanes()
    assert sorted(pt_lanes) == sorted(jx_lanes)
    for pid in jx_lanes:
        assert _stats(pt_lanes[pid]) == _stats(jx_lanes[pid])
    for name in ("orphan_posts_lanes", "duplicate_match_lanes",
                 "reorder_inflation_lanes", "straggler_rank_lanes",
                 "umq_flood_lanes"):
        jx = getattr(jx_analyses, name)(jx_lanes)
        pt = getattr(pt_analyses, name)(pt_lanes)
        assert (sorted((f.kind, f.pid) for f in pt)
                == sorted((f.kind, f.pid) for f in jx))
