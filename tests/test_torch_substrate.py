"""The port's profiling substrate against the JAX package's, on the same
inputs: GraphFrame (construction, JSON, aggregation, arithmetic,
hotspots, totals), regions (``current_path``, ``profiled``), the
comparison layer (``compare_frames``) and the timeline analyses.

The modules are framework-neutral copies, so every output is held to the
reference's exactly: the same JSON, the same numbers, the same findings.
Inputs are made from numpy seeds and handed to both packages.
"""
import math

import numpy as np
import pytest

from repro.core import analyses as jx_analyses
from repro.core import comparison as jx_comparison
from repro.core import regions as jx_regions
from repro.core.collector import Collector as JxCollector
from repro.core.events import Event as JxEvent
from repro.core.graphframe import GraphFrame as JxFrame
from repro_torch.core import analyses as pt_analyses
from repro_torch.core import comparison as pt_comparison
from repro_torch.core import regions as pt_regions
from repro_torch.core.collector import Collector as PtCollector
from repro_torch.core.events import Event as PtEvent
from repro_torch.core.graphframe import GraphFrame as PtFrame

NAMES = ("a", "b", "c", "d", "e")
SEEDS = [0, 1, 2, 3]


def _path_durs(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = int(rng.integers(1, 5))
        path = tuple(NAMES[int(i)] for i in rng.integers(0, len(NAMES), depth))
        out.append((path, int(rng.integers(1, 10**9))))
    return out


def _events(cls, path_durs):
    evs, t = [], 0
    for path, dur in path_durs:
        evs.append(cls(name=path[-1], path=path, category="app",
                       t_start=t, t_end=t + dur))
        t += dur
    return evs


def _same(a, b):
    """Equal, or both NaN (a node no event closed has no statistics)."""
    return a == b or (math.isnan(a) and math.isnan(b))


def _frames(seed, n=40):
    pd = _path_durs(seed, n)
    return (JxFrame.from_events(_events(JxEvent, pd)),
            PtFrame.from_events(_events(PtEvent, pd)))


@pytest.mark.parametrize("seed", SEEDS)
def test_from_events_gives_the_same_json(seed):
    jx, pt = _frames(seed)
    assert pt.to_json() == jx.to_json()
    assert pt.paths() == jx.paths()
    for path in jx.paths():
        for metric in ("count", "sum", "mean", "min", "max", "var", "std"):
            assert _same(pt.value(path, metric), jx.value(path, metric))


@pytest.mark.parametrize("seed", SEEDS)
def test_json_round_trips_across_packages(seed):
    jx, pt = _frames(seed)
    assert PtFrame.from_json(jx.to_json()).to_json() == jx.to_json()
    assert JxFrame.from_json(pt.to_json()).to_json() == pt.to_json()
    assert PtFrame.from_dict(jx.to_dict()).to_dict() == jx.to_dict()


@pytest.mark.parametrize("how", ["mean", "min", "max", "sum", "var"])
def test_aggregate_matches(how):
    runs = [_frames(seed, n=20) for seed in range(5)]
    jx = JxFrame.aggregate([j for j, _ in runs], metric="sum", how=how)
    pt = PtFrame.aggregate([p for _, p in runs], metric="sum", how=how)
    assert pt.to_json() == jx.to_json()


@pytest.mark.parametrize("op", ["div", "sub", "add", "mul"])
def test_tree_arithmetic_matches(op):
    (j1, p1), (j2, p2) = _frames(10), _frames(11)
    for metric in ("mean", "sum"):
        jx = getattr(j1, op)(j2, metric=metric)
        pt = getattr(p1, op)(p2, metric=metric)
        assert pt.to_json() == jx.to_json()


@pytest.mark.parametrize("seed", SEEDS)
def test_hotspots_total_and_tree_match(seed):
    jx, pt = _frames(seed)
    for kw in ({}, {"metric": "sum", "ascending": False},
               {"n": 3, "metric": "max", "leaf_only": True}):
        assert pt.hotspots(**kw) == jx.hotspots(**kw)
    for metric in ("sum", "mean", "count"):
        assert pt.total(metric) == jx.total(metric)
    assert pt.tree(metric="sum") == jx.tree(metric="sum")


@pytest.mark.parametrize("seed", [0, 1])
def test_compare_frames_matches(seed):
    base = [_frames(seed * 10 + r, n=25) for r in range(3)]
    exp = [_frames(seed * 10 + 5 + r, n=25) for r in range(3)]
    jx = jx_comparison.compare_frames([j for j, _ in base],
                                      [j for j, _ in exp],
                                      baseline_name="vendor",
                                      experimental_name="explicit")
    pt = pt_comparison.compare_frames([p for _, p in base],
                                      [p for _, p in exp],
                                      baseline_name="vendor",
                                      experimental_name="explicit")
    for part in ("baseline", "experimental", "ratio"):
        assert getattr(pt, part).to_json() == getattr(jx, part).to_json()
    assert pt.hotspots() == jx.hotspots()
    assert pt.wins() == jx.wins()
    assert pt.tree(metric="value") == jx.tree(metric="value")
    rj, rp = jx.to_report(), pt.to_report()
    assert [str(r) for r in rp.rows] == [str(r) for r in rj.rows]
    assert [str(f) for f in rp.findings] == [str(f) for f in rj.findings]


def _region_run(regions, collector):
    """The same nesting through each package's region API: annotate,
    profiled, current_path, a category switched off."""
    paths = []

    @regions.profiled(category="api", collector=collector)
    def leaf():
        paths.append(regions.current_path())

    with regions.annotate("outer", category="app", collector=collector):
        paths.append(regions.current_path())
        with regions.annotate("mid", category="runtime",
                              collector=collector, bytes=8):
            leaf()
            leaf()
        regions.configure(categories={"app", "api"})
        try:
            with regions.annotate("hidden", category="runtime",
                                  collector=collector):
                leaf()
        finally:
            regions.configure(categories=None)
    return paths, [(e.name, e.path, e.category, e.attrs)
                   for e in collector.drain()]


def test_regions_current_path_and_profiled_match():
    assert pt_regions.DEFAULT_CATEGORIES == jx_regions.DEFAULT_CATEGORIES
    assert (_region_run(pt_regions, PtCollector())
            == _region_run(jx_regions, JxCollector()))


# ------------------------------------------------------------- analyses

def _ev(cls, name, t0, t1, tid=0, pid=0, cat="app"):
    return cls(name, (name,), cat, t0, t1, pid=pid, tid=tid)


def _timeline(cls, seed):
    """A synthetic timeline with waits, lock overlaps across threads,
    irregular durations and gaps, from a numpy seed."""
    rng = np.random.default_rng(seed)
    evs, t = [], 0
    for i in range(60):
        name = ("MPI_Barrier", "BlockingProgress lock", "stencil",
                "MPI_Wait")[int(rng.integers(0, 4))]
        dur = int(rng.integers(10, 200))
        if rng.random() < 0.08:
            dur *= 40
        cat = "collective" if name.startswith("MPI") else "runtime"
        tid = int(rng.integers(0, 2))
        evs.append(_ev(cls, name, t, t + dur, tid=tid, pid=int(
            rng.integers(0, 2)), cat=cat))
        t += int(rng.integers(0, 150)) + (5000 if rng.random() < 0.05 else 0)
    return evs


def _findings(fs):
    return [(f.kind, f.message, f.severity, f.pid, len(f.events))
            for f in fs]


@pytest.mark.parametrize("detector,kw", [
    ("large_waits", {"factor": 3.0}),
    ("contention", {}),
    ("contention", {"name_filter": "BlockingProgress"}),
    ("irregular", {}),
    ("gaps", {"min_gap_ns": 1000}),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeline_detectors_match(detector, kw, seed):
    jx = getattr(jx_analyses, detector)(_timeline(JxEvent, seed), **kw)
    pt = getattr(pt_analyses, detector)(_timeline(PtEvent, seed), **kw)
    assert _findings(pt) == _findings(jx)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_all_and_report_match(seed):
    jx = jx_analyses.analyze_all(_timeline(JxEvent, seed), min_gap_ns=1000)
    pt = pt_analyses.analyze_all(_timeline(PtEvent, seed), min_gap_ns=1000)
    assert _findings(pt) == _findings(jx)
    assert pt_analyses.report(pt) == jx_analyses.report(jx)
