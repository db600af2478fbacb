"""Unified bench/regression harness over the scenario suite.

One entry point — :func:`sweep` — runs every registered scenario under
every engine mode (``fifo``/``linear``/``leaky_umq``) crossed with both
progress-queue disciplines (``shared``/``incoming``), collecting for
each cell:

  * per-op latency (measured wall time / engine ops — advisory, never
    gated),
  * queue-shape statistics: PRQ traversal-depth mean/max and p50/p90
    (from the counter registry's power-of-two histograms), UMQ length
    mean/max,
  * the detector findings ``core.analyses.analyze_all`` raises over the
    scenario's counter snapshot Events plus the progress-lane events
    modeled by :func:`repro_torch.trace.replay.replay_progress`.

Everything except wall time is a pure function of (scenario, params,
seed), so :func:`make_baseline` / :func:`compare_to_baseline` gate exact
regressions: a changed defect-finding set or a drifted queue metric
fails the gate, while machine-dependent timing only informs.

``benchmarks/scenario_sweep.py`` is the CLI; ``scripts/verify.sh`` runs
the smoke-sized sweep against the committed baseline.

A copy of ``repro.workloads.bench``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence, Union

from ..core import analyses
from ..core.counters import (CounterRegistry, CounterStat, counter_stats,
                             lane_events)
from ..faults import (FaultPlan, RecoveryPolicy, build_faulty,
                      composite_kinds, composite_names, composite_plan,
                      default_plan, finish_faults)
from ..faults.plan import KINDS as FAULT_KINDS
from ..match import Fabric, canonical_mode
from ..trace.io import TraceWriter
from ..trace.replay import replay_progress
from .base import (DEFECT_DETECTOR, Params, Scenario, all_scenarios, get,
                   progress_schedule)

SWEEP_FORMAT = "repro.workloads.scenario_sweep"
BASELINE_FORMAT = "repro.workloads.scenario_baseline"
SWEEP_VERSION = 1

ENGINE_MODES = ("fifo", "linear", "leaky_umq")
PROGRESS_MODES = ("shared", "incoming")
DEFECT_KINDS = tuple(sorted(set(DEFECT_DETECTOR.values())))

# injected fault kind -> the detector that must flag it (the fault
# analog of DEFECT_DETECTOR; a departed rank's signature is the posts
# it orphans on every peer, while the delay/join shapes share the
# cross-lane straggler_rank detector)
FAULT_DETECTOR = {
    "drop": "orphan_posts",
    "duplicate": "duplicate_match",
    "reorder": "reorder_inflation",
    "delay": "straggler_rank",
    "rank_leave": "orphan_posts",
    "rank_join": "straggler_rank",
}
FAULT_FINDING_KINDS = tuple(sorted(set(FAULT_DETECTOR.values())))

# recovery-evidence detectors: they may fire only when a RecoveryPolicy
# actively healed something; on every policy-free run (and every healthy
# run under a policy) they must stay silent, exactly like the fault set
RECOVERY_FINDING_KINDS = ("recovered_drop", "retry_storm",
                          "suppressed_duplicate")


def plan_for(name: str, seed: int = 0) -> FaultPlan:
    """The canonical plan for a fault-axis cell name: a single kind's
    default plan, or a composite plan when ``name`` joins kinds with
    ``+`` (e.g. ``drop+delay``)."""
    if "+" in name:
        return composite_plan(name, seed=seed)
    return default_plan(name, seed=seed)


def fault_detector_kinds(name: str) -> tuple:
    """Detectors that evidence injected fault cell ``name`` — the
    single kind's detector, or the union over a composite's members."""
    if "+" in name:
        return tuple(sorted({FAULT_DETECTOR[k]
                             for k in composite_kinds(name)}))
    return (FAULT_DETECTOR[name],)

# number of requests in every scenario's deterministic progress-lane
# schedule (enough backlog for the shared-queue discipline to serialize)
PE_REQUESTS = 32

# deterministic queue metrics a baseline pins exactly (drift -> regression)
GATED_METRICS = ("n_ops", "depth_mean", "depth_max", "umq_mean", "umq_max")


class _RecordSink:
    """Trace hook collecting a live engine's ``pe`` records in memory."""

    def __init__(self):
        self.records: List[Dict] = []

    def emit(self, rec: Dict) -> None:
        self.records.append(rec)


def live_progress_records(progress_mode: str,
                          n_requests: int = PE_REQUESTS,
                          quantum_ns: int = 60_000) -> List[Dict]:
    """Run a real threaded :class:`repro_torch.comm.progress.ProgressEngine`
    and return its recorded submit/process stream in the trace's ``pe``
    encoding (the live analog of :func:`.base.progress_schedule`).

    Each request's work is a device-free busy spin of ``quantum_ns``; the
    user thread enqueues with no gap between submits, so the backlog
    grows far faster than quanta drain and the shared-queue discipline
    serializes submits behind whole processing quanta — the paper's
    Fig. 10 shape, but measured from genuine cross-thread timing rather
    than modeled. The stream is therefore non-deterministic and must
    never feed a committed baseline."""
    from ..comm.progress import ProgressEngine

    def quantum(i: int) -> int:
        deadline = time.perf_counter_ns() + quantum_ns
        while time.perf_counter_ns() < deadline:
            pass
        return i

    sink = _RecordSink()
    eng = ProgressEngine(mode=progress_mode, process_fn=lambda _r: None,
                         trace=sink)
    try:
        reqs = [eng.submit(quantum, i, label=f"live-pe[{i}]")
                for i in range(n_requests)]
        for r in reqs:
            r.wait(timeout=30.0)
    finally:
        eng.shutdown()
    return sink.records


def build_fabric(sc: Scenario, engine_mode: str,
                 registry: Optional[CounterRegistry] = None,
                 trace=None, fault: Optional[FaultPlan] = None,
                 recovery: Optional[RecoveryPolicy] = None) -> Fabric:
    """The fabric configuration every harness drives a scenario through
    (the sweep here, the hotpath throughput bench, golden-trace
    capture): the scenario's deterministic unexpected/wildcard mix over
    a fresh per-run registry. With a ``fault`` plan the returned fabric
    is a :class:`repro_torch.faults.FaultyFabric` applying it to every
    exchange, self-healing when a ``recovery`` policy is set."""
    return build_faulty(fault, recovery=recovery, mode=engine_mode,
                        registry=registry if registry is not None
                        else CounterRegistry(),
                        trace=trace,
                        unexpected_every=sc.unexpected_every,
                        wildcard_every=sc.wildcard_every)


def count_ops(stats: Dict[str, CounterStat]) -> int:
    """Engine ops in one drained stat dict: every arrival observes
    ``match.prq.traversal_depth`` once and every post observes
    ``match.umq.traversal_depth`` once."""
    arr = stats.get("match.prq.traversal_depth")
    post = stats.get("match.umq.traversal_depth")
    return (arr.count if arr else 0) + (post.count if post else 0)


def hist_percentile(st: Optional[CounterStat], q: float) -> float:
    """Approximate percentile of a power-of-two histogram: the lower
    bound of the bucket holding the q-quantile observation."""
    if st is None or not st.bins:
        return 0.0
    total = sum(st.bins.values())
    need = q * total
    seen = 0
    for b in sorted(st.bins):
        seen += st.bins[b]
        if seen >= need:
            return float(b)
    return float(max(st.bins))


@dataclasses.dataclass
class ScenarioRun:
    """One (scenario, engine mode, progress mode) cell of the sweep."""

    scenario: str
    engine_mode: str
    progress_mode: str
    seed: int
    params: Params
    n_ops: int
    wall_s: float
    us_per_op: float
    depth_mean: float
    depth_max: float
    depth_p50: float
    depth_p90: float
    umq_mean: float
    umq_max: float
    finding_kinds: List[str]
    defect_kinds: List[str]
    fault_kinds: List[str] = dataclasses.field(default_factory=list)
    fault: Optional[str] = None       # injected fault kind, if any
    findings: List[analyses.Finding] = dataclasses.field(
        default_factory=list, repr=False)
    trace_path: Optional[str] = None

    def row(self) -> Dict:
        """JSON row for ``scenario_sweep.json``."""
        out = {
            "engine_mode": self.engine_mode,
            "progress_mode": self.progress_mode,
            "n_ops": self.n_ops,
            "us_per_op": round(self.us_per_op, 3),
            "depth_mean": round(self.depth_mean, 4),
            "depth_max": self.depth_max,
            "depth_p50": self.depth_p50,
            "depth_p90": self.depth_p90,
            "umq_mean": round(self.umq_mean, 4),
            "umq_max": self.umq_max,
            "findings": self.finding_kinds,
            "defects": self.defect_kinds,
        }
        # only faulted runs carry the fault columns — healthy rows stay
        # byte-identical to the pre-fault-axis goldens
        if self.fault is not None or self.fault_kinds:
            out["faults"] = self.fault_kinds
        if self.fault is not None:
            out["fault"] = self.fault
        return out


def run_scenario(sc: Union[str, Scenario], engine_mode: str = "fifo",
                 progress_mode: str = "incoming", seed: int = 0,
                 size: str = "full", params: Optional[Params] = None,
                 trace_path: Optional[str] = None,
                 wall_clock: bool = True,
                 trace_schema: Optional[int] = None,
                 telemetry=None,
                 fault: Optional[Union[str, FaultPlan]] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 live_progress: bool = False) -> ScenarioRun:
    """Run one scenario end-to-end under one engine/progress config:
    drive the fabric, snapshot counters, model the progress lanes, run
    every detector. With ``trace_path`` the run is recorded to a
    replayable JSONL trace (``wall_clock=False`` for the byte-identical
    deterministic form; ``trace_schema=2`` for the pre-compaction
    per-op encoding the committed goldens are frozen at). With a
    ``telemetry`` :class:`~repro_torch.telemetry.TelemetryBridge`, the run's
    registry is watched for the duration of the drive — deltas stream
    live — and the final counter events come from the bridge's
    cumulative lanes, so every gated metric and detector finding is
    identical to an unbridged run (the bridge only changes *when* the
    deltas are folded, never what they sum to). ``fault`` injects a
    :class:`repro_torch.faults.FaultPlan` (or the canonical single-kind plan
    named by a kind string, or a canonical composite plan named
    ``kindA+kindB``) into every exchange of the drive; ``recovery``
    applies a :class:`repro_torch.faults.RecoveryPolicy` so the fabric heals
    recoverable faults as they land. ``live_progress`` swaps the
    modeled progress-lane schedule for a real threaded
    :class:`repro_torch.comm.progress.ProgressEngine` run (device-free spin
    quanta, recorded through the engine's own trace hook) — the lane
    events and any contention finding then come from genuine
    cross-thread timing, so the cell is non-deterministic and must
    never feed a committed baseline."""
    if isinstance(sc, str):
        sc = get(sc)
    p = sc.params(size, **(params or {}))
    engine_mode = canonical_mode(engine_mode)
    if progress_mode not in PROGRESS_MODES:
        raise ValueError(f"progress_mode must be one of {PROGRESS_MODES}")
    fault_name: Optional[str] = None
    if isinstance(fault, str):
        fault_name = fault
        fault = plan_for(fault, seed=seed)

    reg = CounterRegistry()
    writer = None
    if trace_path is not None:
        meta = {"scenario": sc.name, "seed": seed, "size": size,
                "params": dict(sorted(p.items())),
                "progress_mode": progress_mode}
        if fault is not None and fault.specs:
            meta["fault"] = fault.to_dict()
        if recovery is not None and recovery.rules:
            meta["recovery"] = recovery.to_dict()
        writer = TraceWriter(
            trace_path, mode=engine_mode, wall_clock=wall_clock,
            schema=trace_schema, meta=meta)
    fab = build_fabric(sc, engine_mode, registry=reg, trace=writer,
                       fault=fault, recovery=recovery)
    src = telemetry.watch(reg) if telemetry is not None else None
    rng = random.Random(seed)
    t0 = time.perf_counter_ns()
    sc.drive(fab, rng, p)
    finish_faults(fab)        # land still-deferred straggler deliveries
    wall_ns = time.perf_counter_ns() - t0

    # deterministic progress-engine lane schedule (same rng continuation
    # for every engine mode, so the stream is mode-independent) — or, on
    # request, a real threaded engine's recorded stream
    if live_progress:
        pe_records = live_progress_records(progress_mode)
    else:
        pe_records = progress_schedule(rng, PE_REQUESTS)
    lanes = telemetry.unwatch(src) if telemetry is not None else None
    if writer is not None:
        for rec in pe_records:
            writer.emit(dict(rec))
        writer.snapshot(reg, lanes=lanes)
        writer.close()

    if lanes is not None:
        events = lane_events(lanes, t_ns=0)
    else:
        events = reg.snapshot_events(t_ns=0)
    events += replay_progress(pe_records, mode=progress_mode)
    findings = analyses.analyze_all(events)
    kinds = sorted({f.kind for f in findings})
    defects = sorted(k for k in kinds if k in DEFECT_KINDS)
    flagged_faults = sorted(k for k in kinds if k in FAULT_FINDING_KINDS)

    stats = counter_stats(events)
    depth = stats.get("match.prq.traversal_depth")
    umq = stats.get("match.umq.length")
    n_ops = count_ops(stats)

    def hv(st, attr):
        return getattr(st, attr) if st is not None and st.count else 0.0

    return ScenarioRun(
        scenario=sc.name, engine_mode=engine_mode,
        progress_mode=progress_mode, seed=seed, params=p, n_ops=n_ops,
        wall_s=wall_ns / 1e9,
        us_per_op=wall_ns / 1e3 / max(n_ops, 1),
        depth_mean=hv(depth, "mean"), depth_max=hv(depth, "vmax"),
        depth_p50=hist_percentile(depth, 0.50),
        depth_p90=hist_percentile(depth, 0.90),
        umq_mean=hv(umq, "mean"), umq_max=hv(umq, "vmax"),
        finding_kinds=kinds, defect_kinds=defects,
        fault_kinds=flagged_faults,
        fault=(fault_name if fault_name is not None
               else fault.kinds[0]
               if fault is not None and len(fault.kinds) == 1 else None),
        findings=findings, trace_path=trace_path)


def cell_key(scenario: str, engine_mode: str, progress_mode: str) -> str:
    return f"{scenario}|{engine_mode}|{progress_mode}"


def sweep(size: str = "full", seed: int = 0,
          engine_modes: Sequence[str] = ENGINE_MODES,
          progress_modes: Sequence[str] = PROGRESS_MODES,
          scenarios: Optional[Sequence[Union[str, Scenario]]] = None,
          telemetry=None,
          faults: Union[bool, Sequence[str]] = False) -> Dict:
    """Every scenario x engine mode x progress mode; returns the
    versioned ``scenario_sweep.json`` payload. A ``telemetry`` bridge
    streams every cell's counters live without changing any gated
    metric (see :func:`run_scenario`). With ``faults`` (True for all
    of ``FAULT_KINDS``, or a cell-name list that may mix single kinds
    and canonical composite names such as ``drop+delay``) every
    scenario additionally runs once per fault cell under the healthy
    engine (fifo+incoming) with that cell's canonical plan injected —
    the fault axis the detector-coverage gate is computed over."""
    scs = ([get(s) if isinstance(s, str) else s for s in scenarios]
           if scenarios is not None else all_scenarios())
    fault_kinds = (list(FAULT_KINDS) if faults is True
                   else list(faults) if faults else [])
    out: Dict = {
        "format": SWEEP_FORMAT, "version": SWEEP_VERSION,
        "size": size, "seed": seed,
        "engine_modes": list(engine_modes),
        "progress_modes": list(progress_modes),
        "scenarios": {},
    }
    if fault_kinds:
        out["fault_kinds"] = fault_kinds
    for sc in scs:
        entry = {"description": sc.description, "stresses": sc.stresses,
                 "expect": list(sc.expect),
                 "fault_expect": list(sc.fault_expect),
                 "params": dict(sorted(sc.params(size).items())),
                 "cells": {}}
        for em in engine_modes:
            for pm in progress_modes:
                run = run_scenario(sc, engine_mode=em, progress_mode=pm,
                                   seed=seed, size=size,
                                   telemetry=telemetry)
                entry["cells"][f"{em}+{pm}"] = run.row()
        if fault_kinds:
            fcells = entry["fault_cells"] = {}
            for kind in fault_kinds:
                run = run_scenario(sc, engine_mode="fifo",
                                   progress_mode="incoming", seed=seed,
                                   size=size, telemetry=telemetry,
                                   fault=kind)
                fcells[kind] = run.row()
        out["scenarios"][sc.name] = entry
    out["defect_coverage"] = defect_coverage(out)
    if fault_kinds:
        out["fault_coverage"] = fault_coverage(out)
    return out


def defect_coverage(results: Dict) -> Dict[str, List[str]]:
    """Which scenarios surfaced each seeded defect: the defect's
    detector fired in the cell where (only) that defect was switched
    on."""
    cover: Dict[str, List[str]] = {d: [] for d in DEFECT_DETECTOR}
    for name, entry in results["scenarios"].items():
        cells = entry["cells"]
        for defect, detector in DEFECT_DETECTOR.items():
            if defect == "shared":
                cell = cells.get("fifo+shared")
            else:
                cell = cells.get(f"{defect}+incoming")
            if cell and detector in cell["defects"]:
                cover[defect].append(name)
    return cover


def fault_coverage(results: Dict) -> Dict[str, List[str]]:
    """Which scenarios surfaced each injected fault cell: the kind's
    dedicated detector fired in that kind's faulted cell (for a
    composite cell, any member kind's detector counts — composite
    pairs are chosen so signatures don't cancel, but which member
    dominates is scenario-dependent)."""
    kinds = results.get("fault_kinds", [])
    cover: Dict[str, List[str]] = {k: [] for k in kinds}
    for name, entry in results["scenarios"].items():
        fcells = entry.get("fault_cells", {})
        for kind in kinds:
            cell = fcells.get(kind)
            if cell and any(d in cell["faults"]
                            for d in fault_detector_kinds(kind)):
                cover[kind].append(name)
    return cover


def check(results: Dict, min_scenarios: int = 6,
          min_coverage: int = 2,
          min_fault_coverage: int = 2) -> List[str]:
    """Acceptance conditions over one sweep payload (CLI + verify.sh
    exit nonzero on any)."""
    failures: List[str] = []
    names = sorted(results["scenarios"])
    if len(names) < min_scenarios:
        failures.append(f"only {len(names)} scenarios registered "
                        f"(need >= {min_scenarios})")
    want_cells = {f"{em}+{pm}" for em in results["engine_modes"]
                  for pm in results["progress_modes"]}
    for name in names:
        entry = results["scenarios"][name]
        missing = want_cells - set(entry["cells"])
        if missing:
            failures.append(f"{name}: missing cells {sorted(missing)}")
        healthy = entry["cells"].get("fifo+incoming")
        if healthy and healthy["defects"]:
            failures.append(f"{name}: healthy fifo+incoming run flagged "
                            f"{healthy['defects']}")
        for defect in entry["expect"]:
            detector = DEFECT_DETECTOR[defect]
            key = ("fifo+shared" if defect == "shared"
                   else f"{defect}+incoming")
            cell = entry["cells"].get(key)
            if cell is not None and detector not in cell["defects"]:
                failures.append(
                    f"{name}: expected {detector!r} under {key} "
                    f"(seeded defect {defect!r}), got {cell['defects']}")
        # fault-class and recovery-evidence detectors must stay silent
        # on every fault-free cell, defect modes included — their
        # thresholds are calibrated so only injected (or real)
        # transport faults / actual healing work cross them
        for key, cell in sorted(entry["cells"].items()):
            noisy = sorted(k for k in cell.get("findings", [])
                           if k in FAULT_FINDING_KINDS
                           or k in RECOVERY_FINDING_KINDS)
            if noisy:
                failures.append(f"{name}: fault-free cell {key} flagged "
                                f"fault findings {noisy}")
        if "fault_cells" in entry:
            for kind in entry.get("fault_expect", []):
                detector = FAULT_DETECTOR[kind]
                cell = entry["fault_cells"].get(kind)
                if cell is not None and detector not in cell["faults"]:
                    failures.append(
                        f"{name}: expected {detector!r} under injected "
                        f"fault {kind!r}, got {cell['faults']}")
    for defect, flagged in results["defect_coverage"].items():
        if len(flagged) < min_coverage:
            failures.append(
                f"seeded defect {defect!r} flagged in only "
                f"{len(flagged)} scenario(s) {flagged} "
                f"(need >= {min_coverage})")
    for kind, flagged in results.get("fault_coverage", {}).items():
        if len(flagged) < min_fault_coverage:
            failures.append(
                f"injected fault {kind!r} flagged in only "
                f"{len(flagged)} scenario(s) {flagged} "
                f"(need >= {min_fault_coverage})")
    return failures


# -- baseline regression gate ---------------------------------------------

def make_baseline(results: Dict) -> Dict:
    """Reduce a sweep payload to the deterministic quantities a
    committed baseline pins. Fault-axis cells (when the sweep ran one)
    are pinned under ``<scenario>|fault:<kind>`` keys with their
    flagged fault findings alongside the same gated metrics."""
    cells: Dict[str, Dict] = {}
    for name, entry in results["scenarios"].items():
        for key, cell in entry["cells"].items():
            em, pm = key.split("+")
            cells[cell_key(name, em, pm)] = {
                "defects": cell["defects"],
                **{m: cell[m] for m in GATED_METRICS},
            }
        for kind, cell in entry.get("fault_cells", {}).items():
            cells[f"{name}|fault:{kind}"] = {
                "defects": cell["defects"],
                "faults": cell["faults"],
                **{m: cell[m] for m in GATED_METRICS},
            }
    return {"format": BASELINE_FORMAT, "version": SWEEP_VERSION,
            "size": results["size"], "seed": results["seed"],
            "cells": cells}


def compare_to_baseline(results: Dict, baseline: Dict,
                        rel_tol: float = 0.0) -> List[str]:
    """Regressions of a sweep vs a committed baseline: changed defect
    findings or drifted deterministic queue metrics. Both are pure
    functions of the seed (and baseline metrics are stored with the
    same rounding the sweep applies), so the default gate is exact —
    any nonzero drift is a behavior change. Timing (us_per_op) is
    intentionally not gated."""
    regressions: List[str] = []
    if baseline.get("format") != BASELINE_FORMAT:
        return [f"baseline has wrong format {baseline.get('format')!r}"]
    if (baseline.get("size"), baseline.get("seed")) != (
            results["size"], results["seed"]):
        return [f"baseline was recorded at size={baseline.get('size')!r} "
                f"seed={baseline.get('seed')!r}, sweep ran "
                f"size={results['size']!r} seed={results['seed']!r} "
                "(regenerate with --write-baseline)"]
    current = make_baseline(results)["cells"]
    base_cells = baseline.get("cells", {})
    if "fault_kinds" not in results:
        # the sweep didn't run the fault axis: judge only the standard
        # cells, so a plain sweep stays green against a faults baseline
        base_cells = {k: v for k, v in base_cells.items()
                      if "|fault:" not in k}
    for key, want in sorted(base_cells.items()):
        got = current.get(key)
        if got is None:
            regressions.append(f"{key}: cell disappeared from the sweep")
            continue
        if got["defects"] != want["defects"]:
            regressions.append(
                f"{key}: defect findings changed "
                f"{want['defects']} -> {got['defects']}")
        if "faults" in want and got.get("faults") != want["faults"]:
            regressions.append(
                f"{key}: fault findings changed "
                f"{want['faults']} -> {got.get('faults')}")
        for m in GATED_METRICS:
            a, b = float(want[m]), float(got[m])
            if abs(b - a) > rel_tol * max(abs(a), 1.0):
                regressions.append(
                    f"{key}: {m} drifted {a:g} -> {b:g}")
    for key in sorted(set(current) - set(baseline.get("cells", {}))):
        regressions.append(f"{key}: new cell not in baseline "
                           "(regenerate with --write-baseline)")
    return regressions
