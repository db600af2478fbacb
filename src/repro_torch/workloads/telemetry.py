"""Telemetry overhead + liveness gates.

Two promises make the bridge "always-on" grade, and this module measures
both (``benchmarks/telemetry_bench.py`` is the CLI, ``results/bench/
telemetry.json`` the payload, ``scripts/verify.sh`` the enforcement):

* **Bounded overhead** — :func:`measure_overhead` drives each scenario
  through the fabric with the bridge attached at its default period and
  detached, *interleaved in pairs* (the same paired-median harness as
  :mod:`repro_torch.workloads.hotpath`: each pair shares one machine-load
  window, the gate consumes the median of per-pair ratios, so absolute
  machine speed cancels out). Each timed section repeats the drive
  enough times to span several poll periods, so the measured cost
  includes real polls, not an idle thread. Gate: median bridged
  throughput >= ``min_ratio`` (default 0.95) of unbridged.

* **Liveness** — :func:`live_finding_check` runs the leaky-UMQ
  ``unexpected_storm`` (throttled, like a real workload with compute
  between messages) while polling the HTTP ``/findings`` endpoint from
  a client thread, and reports whether ``umq_flood`` surfaced *before*
  the workload completed. Gate: it must.

Both runs also assert the accounting invariants the bridge is built on:
ops with the bridge attached equal ops without (no delta lost, none
double-counted), and watch/poll/unwatch leaves the registry empty and
the bridge source-free (no leak).

A copy of ``repro.workloads.telemetry``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import gc
import json
import random
import statistics
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Union

from ..core.counters import CounterRegistry, CounterStat
from ..telemetry import DEFAULT_PERIOD_S, TelemetryBridge, TelemetryServer
from .base import Scenario, all_scenarios, get
from .bench import build_fabric, count_ops
from .hotpath import _no_gc

TELEMETRY_BENCH_FORMAT = "repro.workloads.telemetry_bench"
TELEMETRY_BENCH_VERSION = 1

# the overhead gate: bridged throughput must keep this fraction of
# unbridged (< 5% cost at the default poll period)
MIN_THROUGHPUT_RATIO = 0.95

# drives per timed section — enough wall time to span several poll
# periods at DEFAULT_PERIOD_S, so sections contain real polls
DRIVES_PER_SECTION = 8

OVERHEAD_MODE = "binned"


def _ops_from_lanes(lanes: Dict[int, Dict[str, CounterStat]]) -> int:
    """Engine ops summed over per-pid lanes (same definition as
    :func:`repro_torch.workloads.bench.count_ops`)."""
    merged: Dict[str, CounterStat] = {}
    for per in lanes.values():
        for name, st in per.items():
            cur = merged.get(name)
            if cur is None:
                merged[name] = cur = CounterStat(name=name)
            cur.count += st.count
    return count_ops(merged)


def _drive_n(sc: Scenario, size: str, seed: int,
             registry: CounterRegistry, n: int) -> None:
    for _ in range(n):
        fab = build_fabric(sc, OVERHEAD_MODE, registry=registry)
        sc.drive(fab, random.Random(seed), sc.params(size))


def measure_overhead_cell(sc: Union[str, Scenario], size: str = "smoke",
                          seed: int = 0, repeats: int = 5,
                          period_s: float = DEFAULT_PERIOD_S,
                          drives: int = DRIVES_PER_SECTION,
                          bridge: Optional[TelemetryBridge] = None
                          ) -> Dict:
    """Paired bridged/unbridged throughput for one scenario."""
    if isinstance(sc, str):
        sc = get(sc)
    own_bridge = bridge is None
    if own_bridge:
        bridge = TelemetryBridge(period_s=period_s)
        bridge.start()

    # warmup, untimed
    _drive_n(sc, size, seed, CounterRegistry(), 1)
    ratios: List[float] = []
    best_off_ns = best_on_ns = None
    ops_off = ops_on = 0
    gc.collect()
    with _no_gc():
        for _ in range(max(repeats, 1)):
            # Both sections fold every recorded delta exactly once
            # *inside* the timed window — unbridged as one end-of-run
            # drain, bridged spread over the concurrent polls plus the
            # final unwatch poll. The total merge work is identical, so
            # the ratio isolates what the bridge actually adds: thread
            # wakeups, frame encoding, detector passes, consumer-lock
            # traffic on the producer's buffers.

            # -- bridge off --
            reg = CounterRegistry()
            t0 = time.perf_counter_ns()
            _drive_n(sc, size, seed, reg, drives)
            stats = reg.drain()
            t_off = time.perf_counter_ns() - t0
            ops_off = count_ops(stats)
            if best_off_ns is None or t_off < best_off_ns:
                best_off_ns = t_off

            # -- bridge on (attached for exactly the timed section) --
            reg = CounterRegistry()
            src = bridge.watch(reg)
            t0 = time.perf_counter_ns()
            _drive_n(sc, size, seed, reg, drives)
            lanes = bridge.unwatch(src)
            t_on = time.perf_counter_ns() - t0
            ops_on = _ops_from_lanes(lanes)
            if best_on_ns is None or t_on < best_on_ns:
                best_on_ns = t_on

            # throughput ratio bridged/unbridged, one load window
            ratios.append(t_off / t_on)
    if ops_on != ops_off:
        raise AssertionError(
            f"{sc.name}: bridged run lost deltas "
            f"({ops_on} vs {ops_off} ops)")
    if own_bridge:
        bridge.stop()
        bridge.close()
    return {
        "n_ops": ops_off,
        "drives": drives,
        "off_ops_per_s": round(ops_off / (best_off_ns / 1e9)),
        "on_ops_per_s": round(ops_on / (best_on_ns / 1e9)),
        "throughput_ratio": round(statistics.median(ratios), 4),
    }


def measure_overhead(size: str = "smoke", seed: int = 0, repeats: int = 5,
                     period_s: float = DEFAULT_PERIOD_S,
                     drives: int = DRIVES_PER_SECTION,
                     scenarios: Optional[Sequence[Union[str, Scenario]]]
                     = None) -> Dict:
    """Paired overhead measurement over the scenario suite; one shared
    bridge (started once, watch/unwatch per timed section — the
    always-on deployment shape)."""
    scs = ([get(s) if isinstance(s, str) else s for s in scenarios]
           if scenarios is not None else all_scenarios())
    bridge = TelemetryBridge(period_s=period_s,
                             session=f"overhead[{size}]")
    bridge.start()
    cells: Dict[str, Dict] = {}
    try:
        for sc in scs:
            cells[sc.name] = measure_overhead_cell(
                sc, size=size, seed=seed, repeats=repeats,
                period_s=period_s, drives=drives, bridge=bridge)
    finally:
        bridge.stop()
        leaked_sources = len(bridge.cumulative)
        bridge.close()
    ratios = [c["throughput_ratio"] for c in cells.values()]
    return {
        "period_s": period_s,
        "repeats": repeats,
        "polls": bridge.polls,
        "deltas_total": bridge.deltas_total,
        "leaked_sources": leaked_sources,
        "cells": cells,
        "median_ratio": round(statistics.median(ratios), 4),
        "min_ratio": round(min(ratios), 4),
    }


def live_finding_check(size: str = "smoke", seed: int = 0,
                       period_s: float = 0.01,
                       rounds: int = 6, pause_s: float = 0.05,
                       timeout_s: float = 20.0) -> Dict:
    """Drive the leaky-UMQ storm throttled while a client thread polls
    the HTTP ``/findings`` endpoint; report whether the flood surfaced
    before the workload finished (the liveness promise)."""
    sc = get("unexpected_storm")
    p = sc.params(size)
    bridge = TelemetryBridge(period_s=period_s, session="live_check")
    server = TelemetryServer(bridge).start()
    bridge.start()
    fab = build_fabric(sc, "leaky_umq")
    bridge.watch(fab.reg, name="storm")

    done = threading.Event()
    first_seen: List[float] = []

    def poll_findings():
        deadline = time.perf_counter() + timeout_s
        while not done.is_set() and time.perf_counter() < deadline:
            with urllib.request.urlopen(server.url + "/findings",
                                        timeout=2) as r:
                body = json.loads(r.read())
            if any(f["kind"] == "umq_flood" for f in body):
                if not first_seen:
                    first_seen.append(time.perf_counter())
                return
            time.sleep(period_s)

    watcher = threading.Thread(target=poll_findings, daemon=True)
    rng = random.Random(seed)
    t0 = time.perf_counter()
    watcher.start()
    for _ in range(rounds):
        sc.drive(fab, rng, {**p, "rounds": 1})
        time.sleep(pause_s)
    t_done = time.perf_counter()
    done.set()
    watcher.join(timeout=timeout_s)
    bridge.stop()
    server.stop()
    bridge.close()

    surfaced = bool(first_seen)
    return {
        "scenario": "unexpected_storm", "mode": "leaky_umq",
        "wall_s": round(t_done - t0, 3),
        "surfaced": surfaced,
        "surfaced_mid_run": surfaced and first_seen[0] < t_done,
        "t_first_finding_s": (round(first_seen[0] - t0, 3)
                              if surfaced else None),
        "live_findings": len(bridge.findings_json()),
        "pending_after": fab.reg.drain_stats()["pending"],
    }


def bench(size: str = "smoke", seed: int = 0, repeats: int = 5,
          period_s: float = DEFAULT_PERIOD_S) -> Dict:
    """Full telemetry gate payload (``results/bench/telemetry.json``)."""
    return {
        "format": TELEMETRY_BENCH_FORMAT,
        "version": TELEMETRY_BENCH_VERSION,
        "size": size, "seed": seed,
        "overhead": measure_overhead(size=size, seed=seed,
                                     repeats=repeats, period_s=period_s),
        "live": live_finding_check(size=size, seed=seed),
    }


def check(results: Dict,
          min_ratio: float = MIN_THROUGHPUT_RATIO) -> List[str]:
    """Gate conditions over one telemetry bench payload."""
    failures: List[str] = []
    ov = results.get("overhead", {})
    med = float(ov.get("median_ratio", 0.0))
    if med < min_ratio:
        failures.append(
            f"bridged match throughput is {med:.3f}x unbridged at the "
            f"default poll period (gate: >= {min_ratio:g}x)")
    if ov.get("leaked_sources", 1):
        failures.append(
            f"bridge leaked {ov['leaked_sources']} watched source(s) "
            "after the overhead bench detached everything")
    if not ov.get("polls", 0):
        failures.append("overhead bench saw zero polls — sections too "
                        "short for the poll period, gate is vacuous")
    live = results.get("live", {})
    if not live.get("surfaced_mid_run"):
        failures.append(
            "umq_flood did not surface on /findings before the "
            f"workload completed (live payload: {live})")
    if live.get("pending_after", 1):
        failures.append(
            f"{live.get('pending_after')} deltas still pending after "
            "the live run's final poll (no-loss accounting broken)")
    return failures
