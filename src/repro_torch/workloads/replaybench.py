"""Replay-pipeline throughput + footprint benchmark over the scenario
suite (the perf gate of the trace-pipeline overhaul).

Where :mod:`repro_torch.workloads.hotpath` gates the *live* matching path,
this module gates the *offline* trace pipeline: record every scenario
once (schema v2, the pre-compaction encoding), convert to schema v3
(exercising :func:`repro_torch.trace.io.convert_trace`), then drive both
recordings through both replay pipelines **interleaved in-process**:

  * **old path** — the fully frozen pre-overhaul pipeline
    (:mod:`repro_torch.trace.legacy_replay`): eager per-line reader, one
    python engine call per recorded op with match verification, eager
    event materialization, the pre-overhaul per-delta counter drain.
  * **new path** — schema v3 streamed through the batched replayer
    (:class:`repro_torch.trace.replay.Replayer` with ``check_matches=False``):
    chunked columnar decode straight into the batch engine APIs,
    streaming phase flushes off the columnar counter-sink drain, lazy
    event/progress materialization.

Each repeat times one old/new pair back to back, so the per-cell
speedup is a **paired median** that machine-load swings largely cancel
out of; timed sections run with cyclic GC disabled and a collect
between runs so one path's garbage is never billed to the other. The
aggregate is the op-weighted harmonic mean of the per-cell medians —
equivalent to a total-time ratio with every cell measured inside one
load window. Footprint is gated alongside: total v2 bytes over total
v3 bytes for the same recordings (bytes/op, since the op streams are
identical).

Equivalence is checked, not assumed: for every scenario x engine mode,
the per-phase/per-rank deterministic counter statistics, measured phase
wall spans and detector finding kinds must agree across {frozen legacy,
v2 eager verified, v3 streaming batched}, and the verified replay must
report zero divergences. ``benchmarks/replay_bench.py`` is the CLI.

A copy of ``repro.workloads.replaybench``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import gc
import os
import statistics
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core import analyses
from ..corpus.codec import DETERMINISTIC_COUNTERS
from ..match import canonical_mode
from ..trace.io import convert_trace
from ..trace.legacy_replay import LegacyReplayer
from ..trace.replay import Replayer, ReplayResult
from .base import Scenario, all_scenarios, get
from .bench import run_scenario

REPLAY_FORMAT = "repro.workloads.replay_bench"
BASELINE_FORMAT = "repro.workloads.replay_baseline"
REPLAY_VERSION = 1

# the engine mode whose replay throughput the perf gate pins (the fixed
# design; the defect modes are intentionally slow and checked for
# equivalence only)
GATED_MODE = "binned"
REPLAY_MODES = ("binned", "linear", "leaky_umq")

# counters whose values are pure functions of the recorded op stream
# (canonical home: repro_torch.corpus.codec — the corpus service commits and
# compares exactly this surface)
DETERMINISTIC = DETERMINISTIC_COUNTERS


def record_pair(sc: Union[str, Scenario], size: str = "full",
                seed: int = 0, scratch_dir: Optional[str] = None
                ) -> Tuple[str, str]:
    """Record one scenario live (schema v2, wall-clock timing on — the
    recording a production run would produce) and convert it to v3.
    Returns ``(v2_path, v3_path)``."""
    if isinstance(sc, str):
        sc = get(sc)
    sdir = scratch_dir or tempfile.mkdtemp(prefix="replaybench_")
    v2 = os.path.join(sdir, f"{sc.name}_{size}_v2.jsonl")
    v3 = os.path.join(sdir, f"{sc.name}_{size}_v3.jsonl")
    run_scenario(sc, engine_mode=GATED_MODE, seed=seed, size=size,
                 trace_path=v2, wall_clock=True, trace_schema=2)
    convert_trace(v2, v3, schema=3)
    return v2, v3


def phase_signature(res: ReplayResult) -> List:
    """Comparable per-phase/per-rank replay signature: deterministic
    counter statistics (count/total/extrema/bins), phase identity and
    measured wall span."""
    out = []
    for ph in res.phases:
        cell = {}
        for rank in sorted(ph.stats):
            per = ph.stats[rank]
            cell[rank] = {
                name: (st.count, st.total, st.vmin, st.vmax,
                       dict(st.bins))
                for name, st in sorted(per.items())
                if name in DETERMINISTIC}
        out.append((ph.index, ph.label, ph.op, ph.wall_ns, cell))
    return out


def finding_kinds(res: ReplayResult) -> List[str]:
    """Sorted detector finding kinds over the replay's events."""
    return sorted({f.kind for f in analyses.analyze_all(res.events)})


def equivalence_failures(sc: Union[str, Scenario], v2: str, v3: str,
                         modes: Sequence[str] = REPLAY_MODES
                         ) -> List[str]:
    """Per-phase/per-rank stat + finding equality across {frozen
    legacy, v2 eager verified, v3 streaming batched} for every engine
    mode, plus zero divergences on the verified path."""
    if isinstance(sc, str):
        sc = get(sc)
    failures: List[str] = []
    for mode in modes:
        mode = canonical_mode(mode)
        legacy = LegacyReplayer(mode=mode).run(v2)
        eager = Replayer(mode=mode, check_matches=True).run(v2)
        stream = Replayer(mode=mode, check_matches=False).run(v3)
        if eager.divergences:
            failures.append(
                f"{sc.name}/{mode}: verified replay diverged from the "
                f"recorded match order ({len(eager.divergences)} ops)")
        sig = phase_signature(legacy)
        for label, res in (("v2-eager", eager), ("v3-streaming", stream)):
            if res.n_ops != legacy.n_ops:
                failures.append(
                    f"{sc.name}/{mode}: {label} replayed {res.n_ops} "
                    f"ops, legacy replayed {legacy.n_ops}")
            if phase_signature(res) != sig:
                failures.append(
                    f"{sc.name}/{mode}: {label} per-phase/per-rank "
                    f"counter stats differ from the frozen replayer's")
        kinds = finding_kinds(legacy)
        for label, res in (("v2-eager", eager), ("v3-streaming", stream)):
            got = finding_kinds(res)
            if got != kinds:
                failures.append(
                    f"{sc.name}/{mode}: {label} detector findings "
                    f"{got} != legacy {kinds}")
    return failures


def measure_cell(sc: Union[str, Scenario], size: str = "full",
                 seed: int = 0, repeats: int = 7,
                 scratch_dir: Optional[str] = None,
                 paths: Optional[Tuple[str, str]] = None) -> Dict:
    """Paired old/new replay throughput + trace footprint for one
    scenario (gated engine mode). ``paths`` reuses an existing
    ``(v2, v3)`` recording (left on disk); otherwise the cell records
    its own pair and removes it."""
    if isinstance(sc, str):
        sc = get(sc)
    own = paths is None
    v2, v3 = (record_pair(sc, size=size, seed=seed,
                          scratch_dir=scratch_dir)
              if own else paths)
    v2_bytes = os.path.getsize(v2)
    v3_bytes = os.path.getsize(v3)

    legacy = LegacyReplayer(mode=GATED_MODE)
    current = Replayer(mode=GATED_MODE, check_matches=False)
    legacy.run(v2)                       # warmup (untimed)
    current.run(v3)
    n_ops = 0
    best_lns = best_cns = None
    ratios: List[float] = []
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        for _ in range(max(repeats, 1)):
            # each legacy/current pair runs back to back, so its ratio
            # is taken under one machine-load window; the median over
            # pairs is what the gate consumes
            t0 = time.perf_counter_ns()
            res_l = legacy.run(v2)
            lt = time.perf_counter_ns() - t0
            nl = res_l.n_ops
            res_l = None
            t0 = time.perf_counter_ns()
            res_c = current.run(v3)
            ct = time.perf_counter_ns() - t0
            n_ops = res_c.n_ops
            res_c = None
            if nl != n_ops:
                raise AssertionError(
                    f"replayers disagree on the op stream for "
                    f"{sc.name}: {nl} vs {n_ops} ops")
            ratios.append(lt / ct)
            if best_lns is None or lt < best_lns:
                best_lns = lt
            if best_cns is None or ct < best_cns:
                best_cns = ct
            # collect between runs so neither path's garbage lands in
            # the other's timed window
            gc.enable()
            gc.collect()
            gc.disable()
    finally:
        if was:
            gc.enable()
    if own:
        try:
            os.remove(v2)
            os.remove(v3)
        except OSError:
            pass
    return {
        "n_ops": n_ops,
        "replay_ops_per_s": round(n_ops / (best_cns / 1e9)),
        "replay_us_per_op": round(best_cns / 1e3 / max(n_ops, 1), 3),
        "legacy_ops_per_s": round(n_ops / (best_lns / 1e9)),
        "legacy_us_per_op": round(best_lns / 1e3 / max(n_ops, 1), 3),
        "speedup_vs_legacy": round(statistics.median(ratios), 3),
        "v2_bytes": v2_bytes,
        "v3_bytes": v3_bytes,
        "v2_bytes_per_op": round(v2_bytes / max(n_ops, 1), 2),
        "v3_bytes_per_op": round(v3_bytes / max(n_ops, 1), 2),
        "shrink_vs_v2": round(v2_bytes / max(v3_bytes, 1), 3),
    }


def bench(size: str = "full", seed: int = 0, repeats: int = 7,
          scenarios: Optional[Sequence[Union[str, Scenario]]] = None,
          check_equivalence: bool = True) -> Dict:
    """Every scenario: paired throughput + footprint cells, the
    aggregate, and (by default) the three-way equivalence sweep across
    all engine modes. Returns the versioned ``replay.json`` payload."""
    scs = ([get(s) if isinstance(s, str) else s for s in scenarios]
           if scenarios is not None else all_scenarios())
    out: Dict = {
        "format": REPLAY_FORMAT, "version": REPLAY_VERSION,
        "size": size, "seed": seed, "repeats": repeats,
        "gated_mode": GATED_MODE,
        "replay_modes": list(REPLAY_MODES),
        "cells": {},
        "equivalence_failures": [],
    }
    sdir = tempfile.mkdtemp(prefix="replaybench_")
    for sc in scs:
        # one recording per scenario, shared by the timed cell and the
        # equivalence sweep (live scenario recording dominates setup)
        pair = record_pair(sc, size=size, seed=seed, scratch_dir=sdir)
        out["cells"][sc.name] = measure_cell(
            sc, size=size, seed=seed, repeats=repeats, paths=pair)
        if check_equivalence:
            out["equivalence_failures"] += equivalence_failures(
                sc, *pair)
        for path in pair:
            try:
                os.remove(path)
            except OSError:
                pass
    try:
        os.rmdir(sdir)
    except OSError:
        pass
    out["aggregate"] = aggregate(out)
    return out


def aggregate(results: Dict) -> Dict:
    """Sweep-level rates: total ops over total best wall time per path,
    the op-weighted harmonic mean of the per-cell paired-median
    speedups (== a total-time ratio measured inside one load window per
    cell), and total v2/v3 bytes."""
    ops = s = ls = w = b2 = b3 = 0.0
    for cell in results["cells"].values():
        ops += cell["n_ops"]
        s += cell["n_ops"] / cell["replay_ops_per_s"]
        ls += cell["n_ops"] / cell["legacy_ops_per_s"]
        w += cell["n_ops"] / cell["speedup_vs_legacy"]
        b2 += cell["v2_bytes"]
        b3 += cell["v3_bytes"]
    return {
        "n_ops": int(ops),
        "replay_ops_per_s": round(ops / s) if s else 0,
        "legacy_ops_per_s": round(ops / ls) if ls else 0,
        "speedup_vs_legacy": round(ops / w, 3) if w else 0.0,
        "v2_bytes": int(b2),
        "v3_bytes": int(b3),
        "shrink_vs_v2": round(b2 / b3, 3) if b3 else 0.0,
    }


# -- baseline perf gate ----------------------------------------------------

def make_baseline(results: Dict) -> Dict:
    """Reduce a bench payload to the committed baseline: the op streams
    (pinned exactly — a drifted op count means the comparison measures
    a different workload) and the throughputs/ratios this machine
    achieved, for the perf trajectory."""
    return {"format": BASELINE_FORMAT, "version": REPLAY_VERSION,
            "size": results["size"], "seed": results["seed"],
            "gated_mode": results["gated_mode"],
            "cells": {name: {k: c[k] for k in
                             ("n_ops", "replay_ops_per_s",
                              "legacy_ops_per_s", "speedup_vs_legacy",
                              "v2_bytes", "v3_bytes", "shrink_vs_v2")}
                      for name, c in sorted(results["cells"].items())},
            "aggregate": results["aggregate"]}


def compare_to_baseline(results: Dict, baseline: Dict,
                        min_speedup: float = 2.5,
                        min_shrink: float = 3.0) -> List[str]:
    """Perf-gate failures of a bench run.

    Gated quantities are *in-run*: the aggregate paired-median speedup
    of the batched v3 replay over the frozen pipeline, and the v2/v3
    byte ratio of the same recordings. The committed baseline pins the
    op streams and v3 byte sizes (the encoding is deterministic up to
    ``t_wall`` digits, so sizes are pinned within a small tolerance)
    and records absolute rates for the trajectory (reported, never
    gated: machine load varies)."""
    failures: List[str] = []
    if baseline.get("format") != BASELINE_FORMAT:
        return [f"baseline has wrong format {baseline.get('format')!r}"]
    if (baseline.get("size"), baseline.get("seed")) != (
            results["size"], results["seed"]):
        return [f"baseline was recorded at size={baseline.get('size')!r} "
                f"seed={baseline.get('seed')!r}, bench ran "
                f"size={results['size']!r} seed={results['seed']!r} "
                "(regenerate with --write-baseline)"]
    for name, want in sorted(baseline.get("cells", {}).items()):
        got = results["cells"].get(name)
        if got is None:
            failures.append(f"{name}: cell disappeared from the bench")
        elif got["n_ops"] != want["n_ops"]:
            failures.append(
                f"{name}: op stream changed ({want['n_ops']} -> "
                f"{got['n_ops']} ops) — not a like-for-like comparison")
    agg = results.get("aggregate", {})
    ratio = float(agg.get("speedup_vs_legacy", 0.0))
    if ratio <= 0:
        failures.append("no in-run legacy comparison")
    elif ratio < min_speedup:
        failures.append(
            f"aggregate replay throughput is only {ratio:.2f}x the "
            f"frozen pre-overhaul pipeline's, measured in-run "
            f"(gate: >= {min_speedup:g}x)")
    shrink = float(agg.get("shrink_vs_v2", 0.0))
    if shrink < min_shrink:
        failures.append(
            f"v3 traces are only {shrink:.2f}x smaller than v2 "
            f"(gate: >= {min_shrink:g}x bytes/op)")
    failures += results.get("equivalence_failures", [])
    return failures
