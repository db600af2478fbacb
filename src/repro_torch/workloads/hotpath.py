"""Hot-path throughput benchmark over the scenario suite.

Where :mod:`repro_torch.workloads.bench` gates *behavior* (defect findings and
deterministic queue metrics), this module gates *speed*: it measures the
three hot paths the matching engine's instrumentation story depends on,
per scenario x engine mode, against a committed machine-local baseline
recorded on the pre-overhaul engine:

  * **match ops/sec** — drive the scenario through a :class:`repro_torch.match
    .Fabric` with counters on and tracing off (the exact configuration
    ``benchmarks/scenario_sweep.py`` times) and divide engine ops
    (posts + arrivals) by wall time. This is the gated headline number.
  * **trace records/sec** — the same drive with a live
    :class:`repro_torch.trace.TraceWriter` attached; records written (header,
    ops, phase markers, snapshots) over wall time.
  * **drain deltas/sec** — drive untimed, then time
    :meth:`repro_torch.core.counters.CounterRegistry.drain` over the buffered
    counter deltas the drive produced.

Every measurement is best-of-``repeats`` to shed scheduler noise, and the
op stream is the deterministic one the scenario's seed pins, so run-to-run
variation is wall-clock only. :func:`compare_to_baseline` enforces the
perf gate: aggregate match throughput in the gated engine mode must be at
least ``min_speedup`` x the committed baseline's (the overhaul PR gates at
3x; later PRs gate against their own regenerated baselines at ~1x to
catch regressions). ``benchmarks/hotpath_bench.py`` is the CLI.

A copy of ``repro.workloads.hotpath``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import contextlib
import gc
import os
import random
import statistics
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Union

from ..core.counters import CounterRegistry
from ..match import canonical_mode
from ..match.legacy import LegacyFabric
from ..trace.io import TraceWriter
from .base import Scenario, all_scenarios, get
from .bench import build_fabric, count_ops

HOTPATH_FORMAT = "repro.workloads.hotpath_bench"
BASELINE_FORMAT = "repro.workloads.hotpath_baseline"
HOTPATH_VERSION = 1

# the engine mode whose aggregate match throughput the perf gate pins
# (the fixed design: the defect modes are intentionally slow)
GATED_MODE = "binned"
HOTPATH_MODES = ("binned", "linear", "leaky_umq")


@contextlib.contextmanager
def _no_gc():
    """Cyclic GC off for one timed section (standard bench hygiene: the
    collector otherwise charges whichever drive happens to cross an
    allocation threshold for every prior section's garbage)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def drive_scenario(sc: Scenario, engine_mode: str, size: str = "full",
                   seed: int = 0,
                   registry: Optional[CounterRegistry] = None,
                   trace=None):
    """Drive one scenario once through a fresh fabric; returns it."""
    fab = build_fabric(sc, engine_mode, registry=registry, trace=trace)
    sc.drive(fab, random.Random(seed), sc.params(size))
    return fab


def drive_scenario_legacy(sc: Scenario, engine_mode: str,
                          size: str = "full", seed: int = 0,
                          registry: Optional[CounterRegistry] = None):
    """Same drive through the frozen pre-overhaul engine
    (:mod:`repro_torch.match.legacy`) — the bench's in-process yardstick."""
    fab = LegacyFabric(mode=engine_mode,
                       registry=registry if registry is not None
                       else CounterRegistry(),
                       unexpected_every=sc.unexpected_every,
                       wildcard_every=sc.wildcard_every)
    sc.drive(fab, random.Random(seed), sc.params(size))
    return fab


def measure_cell(sc: Union[str, Scenario], engine_mode: str,
                 size: str = "full", seed: int = 0,
                 repeats: int = 7, scratch_dir: Optional[str] = None
                 ) -> Dict:
    """All three hot-path throughputs for one (scenario, mode) cell."""
    if isinstance(sc, str):
        sc = get(sc)
    engine_mode = canonical_mode(engine_mode)

    # -- match ops/sec, current vs frozen pre-overhaul engine --
    # The two engines run interleaved in the same timed section, so the
    # speedup ratio is insensitive to machine-load swings that make
    # absolute throughput comparisons across runs unreliable.
    best_ns = best_lns = None
    n_ops = n_legacy = 0
    ratios = []
    drive_scenario(sc, engine_mode, size=size, seed=seed,
                   registry=CounterRegistry())     # warmup (untimed)
    drive_scenario_legacy(sc, engine_mode, size=size, seed=seed,
                          registry=CounterRegistry())
    gc.collect()
    with _no_gc():
        for _ in range(max(repeats, 1)):
            reg = CounterRegistry()
            t0 = time.perf_counter_ns()
            drive_scenario_legacy(sc, engine_mode, size=size, seed=seed,
                                  registry=reg)
            lt = time.perf_counter_ns() - t0
            n_legacy = count_ops(reg.drain())
            if best_lns is None or lt < best_lns:
                best_lns = lt
            reg = CounterRegistry()
            t0 = time.perf_counter_ns()
            drive_scenario(sc, engine_mode, size=size, seed=seed,
                           registry=reg)
            ct = time.perf_counter_ns() - t0
            n_ops = count_ops(reg.drain())
            if best_ns is None or ct < best_ns:
                best_ns = ct
            # each legacy/current pair runs back to back, so its ratio
            # is taken under one machine-load window; the median over
            # pairs is what the gate consumes
            ratios.append(lt / ct)
    if n_legacy != n_ops:
        raise AssertionError(
            f"legacy engine replayed a different op stream for "
            f"{sc.name}/{engine_mode}: {n_legacy} vs {n_ops} ops")
    match_ops_per_s = n_ops / (best_ns / 1e9)
    legacy_ops_per_s = n_ops / (best_lns / 1e9)
    speedup = statistics.median(ratios)

    # -- trace records/sec (live wall-clock writer attached) --
    own_scratch = scratch_dir is None
    sdir = scratch_dir or tempfile.mkdtemp(prefix="hotpath_")
    tpath = os.path.join(sdir, f"{sc.name}_{engine_mode}.jsonl")
    best_tns, n_recs = None, 0
    gc.collect()
    with _no_gc():
        for _ in range(max(repeats, 1)):
            reg = CounterRegistry()
            writer = TraceWriter(
                tpath, mode=engine_mode,
                meta={"scenario": sc.name, "bench": "hotpath"})
            t0 = time.perf_counter_ns()
            drive_scenario(sc, engine_mode, size=size, seed=seed,
                           registry=reg, trace=writer)
            writer.snapshot(reg)
            writer.close()
            dt = time.perf_counter_ns() - t0
            n_recs = writer.n_records
            if best_tns is None or dt < best_tns:
                best_tns = dt
    trace_recs_per_s = n_recs / (best_tns / 1e9)
    try:
        os.remove(tpath)
        if own_scratch:
            os.rmdir(sdir)
    except OSError:
        pass

    # -- drain deltas/sec (merge cost of the buffered counter deltas) --
    best_dns, n_deltas = None, 0
    gc.collect()
    with _no_gc():
        for _ in range(max(repeats, 1)):
            reg = CounterRegistry()
            drive_scenario(sc, engine_mode, size=size, seed=seed,
                           registry=reg)
            n_deltas = reg.pending_deltas()
            t0 = time.perf_counter_ns()
            reg.drain()
            dt = time.perf_counter_ns() - t0
            if best_dns is None or dt < best_dns:
                best_dns = dt
    drain_deltas_per_s = n_deltas / (best_dns / 1e9)

    return {
        "n_ops": n_ops,
        "match_ops_per_s": round(match_ops_per_s),
        "match_us_per_op": round(best_ns / 1e3 / max(n_ops, 1), 3),
        "legacy_ops_per_s": round(legacy_ops_per_s),
        "speedup_vs_legacy": round(speedup, 3),
        "n_trace_records": n_recs,
        "trace_recs_per_s": round(trace_recs_per_s),
        "n_drain_deltas": n_deltas,
        "drain_deltas_per_s": round(drain_deltas_per_s),
    }


def cell_key(scenario: str, engine_mode: str) -> str:
    return f"{scenario}|{engine_mode}"


def bench(size: str = "full", seed: int = 0, repeats: int = 7,
          engine_modes: Sequence[str] = HOTPATH_MODES,
          scenarios: Optional[Sequence[Union[str, Scenario]]] = None
          ) -> Dict:
    """Every scenario x engine mode; returns the versioned
    ``hotpath.json`` payload (aggregates keyed per mode)."""
    scs = ([get(s) if isinstance(s, str) else s for s in scenarios]
           if scenarios is not None else all_scenarios())
    out: Dict = {
        "format": HOTPATH_FORMAT, "version": HOTPATH_VERSION,
        "size": size, "seed": seed, "repeats": repeats,
        "gated_mode": GATED_MODE,
        "engine_modes": list(engine_modes),
        "cells": {},
    }
    sdir = tempfile.mkdtemp(prefix="hotpath_")
    for sc in scs:
        for em in engine_modes:
            out["cells"][cell_key(sc.name, em)] = measure_cell(
                sc, em, size=size, seed=seed, repeats=repeats,
                scratch_dir=sdir)
    try:
        os.rmdir(sdir)
    except OSError:
        pass
    out["aggregate"] = {
        em: aggregate(out, em) for em in engine_modes}
    return out


def aggregate(results: Dict, engine_mode: str) -> Dict:
    """Sweep-level throughput for one mode: total ops over total best
    wall time (equivalently: the op-weighted harmonic mean of the
    per-scenario rates)."""
    ops = s = ls = w = trace_n = trace_s = deltas = drain_s = 0.0
    for key, cell in results["cells"].items():
        if key.rsplit("|", 1)[1] != engine_mode:
            continue
        ops += cell["n_ops"]
        s += cell["n_ops"] / cell["match_ops_per_s"]
        ls += cell["n_ops"] / cell["legacy_ops_per_s"]
        # op-weighted harmonic mean of the per-cell paired-median
        # speedups: equivalent to a total-time ratio with every cell's
        # ratio measured inside one load window
        w += cell["n_ops"] / cell["speedup_vs_legacy"]
        trace_n += cell["n_trace_records"]
        trace_s += cell["n_trace_records"] / cell["trace_recs_per_s"]
        deltas += cell["n_drain_deltas"]
        drain_s += cell["n_drain_deltas"] / cell["drain_deltas_per_s"]
    return {
        "n_ops": int(ops),
        "match_ops_per_s": round(ops / s) if s else 0,
        "legacy_ops_per_s": round(ops / ls) if ls else 0,
        "speedup_vs_legacy": round(ops / w, 3) if w else 0.0,
        "trace_recs_per_s": round(trace_n / trace_s) if trace_s else 0,
        "drain_deltas_per_s": round(deltas / drain_s) if drain_s else 0,
    }


# -- baseline perf gate ----------------------------------------------------

def make_baseline(results: Dict) -> Dict:
    """Reduce a bench payload to the committed baseline: the recorded
    throughputs this machine achieved (pre-overhaul at PR time; later
    regenerations move the bar to the then-current engine)."""
    return {"format": BASELINE_FORMAT, "version": HOTPATH_VERSION,
            "size": results["size"], "seed": results["seed"],
            "gated_mode": results["gated_mode"],
            "cells": {k: {"match_ops_per_s": c["match_ops_per_s"],
                          "n_ops": c["n_ops"],
                          "trace_recs_per_s": c["trace_recs_per_s"],
                          "drain_deltas_per_s": c["drain_deltas_per_s"],
                          **({"legacy_ops_per_s": c["legacy_ops_per_s"],
                              "speedup_vs_legacy":
                                  c["speedup_vs_legacy"]}
                             if "legacy_ops_per_s" in c else {})}
                      for k, c in sorted(results["cells"].items())},
            "aggregate": results["aggregate"]}


def compare_to_baseline(results: Dict, baseline: Dict,
                        min_speedup: float = 3.0) -> List[str]:
    """Perf-gate failures of a bench run.

    The gate is the *in-run* aggregate speedup of the gated engine mode
    over the frozen pre-overhaul engine (measured interleaved in the
    same process, so machine-load swings cancel out of the ratio).
    The committed baseline pins the op stream — a changed ``n_ops``
    means the comparison is measuring a different workload, which is a
    setup error, not a perf result — and records the absolute
    throughputs this machine achieved, for the trajectory (absolute
    rates are reported, never gated: this box's load varies too much
    across runs)."""
    failures: List[str] = []
    if baseline.get("format") != BASELINE_FORMAT:
        return [f"baseline has wrong format {baseline.get('format')!r}"]
    if (baseline.get("size"), baseline.get("seed")) != (
            results["size"], results["seed"]):
        return [f"baseline was recorded at size={baseline.get('size')!r} "
                f"seed={baseline.get('seed')!r}, bench ran "
                f"size={results['size']!r} seed={results['seed']!r} "
                "(regenerate with --write-baseline)"]
    mode = baseline.get("gated_mode", GATED_MODE)
    for key, want in sorted(baseline.get("cells", {}).items()):
        got = results["cells"].get(key)
        if got is None:
            failures.append(f"{key}: cell disappeared from the bench")
        elif got["n_ops"] != want["n_ops"]:
            failures.append(
                f"{key}: op stream changed ({want['n_ops']} -> "
                f"{got['n_ops']} ops) — not a like-for-like comparison")
    cur = results.get("aggregate", {}).get(mode, {})
    ratio = float(cur.get("speedup_vs_legacy", 0.0))
    if ratio <= 0:
        failures.append(f"no in-run legacy comparison for mode {mode!r}")
    elif ratio < min_speedup:
        failures.append(
            f"aggregate {mode} match throughput is only {ratio:.2f}x the "
            f"pre-overhaul engine's, measured in-run "
            f"(gate: >= {min_speedup:g}x)")
    return failures

