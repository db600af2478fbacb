"""Measurement + gate logic for ``benchmarks/corpus_bench.py``.

Three gated sections, one shared spawn pool:

  1. **corpus regression** — the committed ``tests/corpus`` manifest
     replayed through the current engine (one pool task per trace);
     any divergence from the committed expectations is a failure.
  2. **shard equivalence** — for every corpus entry, ``parallel_replay``
     (rank partition at the gated job count, plus a phase-partition
     pass) must produce the exact serial signature and finding kinds.
  3. **speedup** — paired-median serial-vs-parallel sweep over freshly
     recorded traces: each repeat times the whole serial sweep and the
     whole sharded parallel sweep back to back (one machine-load
     window), and the median ratio is gated.

Honest-gate note: a parallel speedup requires parallel hardware. The
speedup gate is **cores-aware** — enforced only when the process may
schedule on >= 2 CPUs (``usable_cores()``); on a single-core host the
ratio is still measured and recorded (expect < 1x: pool overhead with
no parallelism) but reported as SKIPPED with a loud note rather than
failed, the same honesty discipline the replay-bench gate established.
Correctness sections (1) and (2) gate everywhere, unconditionally.

A copy of ``repro.workloads.corpusbench``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import gc
import os
import statistics
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..corpus import (InlinePool, ReplayPool, finding_kinds, merge_shards,
                      parallel_replay, plan_shards, run_corpus,
                      shard_worker, signature, usable_cores)
from ..corpus.store import CorpusStore
from ..trace.replay import Replayer, scan_partition
from .bench import run_scenario
from .base import names

CORPUS_BENCH_FORMAT = "repro.workloads.corpus_bench"
CORPUS_BASELINE_FORMAT = "repro.workloads.corpus_baseline"
CORPUS_BENCH_VERSION = 1

# the engine mode the speedup sweep records and replays (the fixed
# design, matching the other perf gates)
GATED_MODE = "fifo"


def default_corpus_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "..",
                                         "tests", "corpus"))


# -- section 2: shard equivalence ------------------------------------------

def equivalence_failures(store: CorpusStore, pool, jobs: int
                         ) -> List[str]:
    """Sharded-vs-serial stat/finding equality over every corpus entry:
    rank partition at the gated job count for all, phase partition for
    every multi-phase entry (the low-rank fallback path)."""
    failures: List[str] = []
    serial_rep = Replayer(check_matches=False)
    for entry in store.entries:
        path = store.path(entry)
        serial = serial_rep.run(path)
        sig = signature(serial)
        kinds = finding_kinds(serial)
        cells = [("rank", jobs)]
        if entry.n_phases >= 2:
            cells.append(("phase", min(jobs, entry.n_phases)))
        for partition, j in cells:
            got = parallel_replay(path, jobs=j, partition=partition,
                                  pool=pool)
            if got.n_ops != serial.n_ops:
                failures.append(
                    f"{entry.id}/{partition}: parallel replayed "
                    f"{got.n_ops} ops, serial {serial.n_ops}")
            if signature(got) != sig:
                failures.append(
                    f"{entry.id}/{partition}: sharded per-phase/"
                    f"per-rank stats differ from serial replay")
            if finding_kinds(got) != kinds:
                failures.append(
                    f"{entry.id}/{partition}: sharded findings "
                    f"{finding_kinds(got)} != serial {kinds}")
    return failures


# -- section 3: paired serial/parallel sweep speedup -----------------------

def _record_sweep(size: str, seed: int, scratch: str
                  ) -> List[Tuple[str, str]]:
    out = []
    for sc in names():
        path = os.path.join(scratch, f"{sc}_{size}.jsonl")
        run_scenario(sc, engine_mode=GATED_MODE, seed=seed, size=size,
                     trace_path=path, wall_clock=False, trace_schema=3)
        out.append((sc, path))
    return out


def measure_speedup(sweep: Sequence[Tuple[str, str]], pool,
                    jobs: int, repeats: int = 5,
                    partition: str = "rank") -> Dict:
    """Paired-median sweep timing. Shard plans are computed once
    outside the timed window (a regression service reuses them across
    runs); each repeat then times serial-sweep and parallel-sweep back
    to back so the ratio is taken under one load window."""
    serial_rep = Replayer(mode=GATED_MODE, check_matches=False)
    all_tasks: List[Tuple] = []
    spans: List[Tuple[int, int]] = []
    for _, path in sweep:
        scan = scan_partition(path)
        shards = plan_shards(scan, jobs, partition)
        tasks = [(path, GATED_MODE, None,
                  spec if kind == "rank" else None,
                  spec if kind == "phase" else None)
                 for kind, spec in shards]
        spans.append((len(all_tasks), len(all_tasks) + len(tasks)))
        all_tasks.extend(tasks)

    # warmup both paths (untimed): engine/jit-free but allocator and
    # pool workers settle
    n_ops = sum(serial_rep.run(path).n_ops for _, path in sweep)
    parts = pool.map(shard_worker, all_tasks)
    for (a, b) in spans:
        merge_shards(parts[a:b], partition)

    ratios: List[float] = []
    best_s = best_p = None
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter_ns()
            for _, path in sweep:
                serial_rep.run(path)
            st = time.perf_counter_ns() - t0
            t0 = time.perf_counter_ns()
            parts = pool.map(shard_worker, all_tasks)
            merged = [merge_shards(parts[a:b], partition)
                      for a, b in spans]
            pt = time.perf_counter_ns() - t0
            got_ops = sum(m.n_ops for m in merged)
            if got_ops != n_ops:
                raise AssertionError(
                    f"parallel sweep replayed {got_ops} ops, serial "
                    f"{n_ops}")
            ratios.append(st / pt)
            if best_s is None or st < best_s:
                best_s = st
            if best_p is None or pt < best_p:
                best_p = pt
            gc.enable()
            gc.collect()
            gc.disable()
    finally:
        if was:
            gc.enable()
    return {
        "partition": partition,
        "jobs": jobs,
        "cores": usable_cores(),
        "n_traces": len(sweep),
        "n_shards": len(all_tasks),
        "n_ops": n_ops,
        "serial_s": round(best_s / 1e9, 6),
        "parallel_s": round(best_p / 1e9, 6),
        "serial_ops_per_s": round(n_ops / (best_s / 1e9)),
        "parallel_ops_per_s": round(n_ops / (best_p / 1e9)),
        "speedup": round(statistics.median(ratios), 3),
        "ratios": [round(r, 3) for r in ratios],
    }


# -- entry point -----------------------------------------------------------

def bench(size: str = "full", seed: int = 0, repeats: int = 5,
          jobs: int = 4, corpus_root: Optional[str] = None,
          pool=None) -> Dict:
    root = corpus_root or default_corpus_root()
    own_pool = pool is None
    if own_pool:
        pool = (ReplayPool(jobs=jobs) if jobs > 1 else InlinePool())
    try:
        store = CorpusStore.load(root)
        corpus_res = run_corpus(store, pool=pool)
        eq_failures = equivalence_failures(store, pool, jobs)
        scratch = tempfile.mkdtemp(prefix="corpusbench_")
        sweep = []
        try:
            sweep = _record_sweep(size, seed, scratch)
            speedup = measure_speedup(sweep, pool, jobs,
                                      repeats=repeats)
        finally:
            for _, path in sweep:
                try:
                    os.remove(path)
                except OSError:
                    pass
            try:
                os.rmdir(scratch)
            except OSError:
                pass
    finally:
        if own_pool:
            pool.close()
    return {
        "format": CORPUS_BENCH_FORMAT,
        "version": CORPUS_BENCH_VERSION,
        "size": size,
        "seed": seed,
        "repeats": repeats,
        "corpus": {
            "root": root,
            "ok": corpus_res.ok,
            "entries": len(corpus_res.results),
            "n_ops": sum(r.n_ops for r in corpus_res.results),
            "failures": corpus_res.failures,
        },
        "equivalence_failures": eq_failures,
        "speedup": speedup,
    }


def gate_failures(results: Dict, min_speedup: float) -> List[str]:
    """Hard failures for this run. The speedup gate only arms on
    parallel hardware (cores >= 2); correctness always gates."""
    failures: List[str] = []
    if not results["corpus"]["ok"]:
        failures += [f"corpus: {f}"
                     for f in results["corpus"]["failures"]]
    failures += results["equivalence_failures"]
    sp = results["speedup"]
    if sp["cores"] >= 2:
        if sp["speedup"] < min_speedup:
            failures.append(
                f"parallel sweep speedup {sp['speedup']:.2f}x < "
                f"required {min_speedup:g}x "
                f"(jobs={sp['jobs']}, cores={sp['cores']})")
    return failures


def speedup_note(results: Dict, min_speedup: float) -> str:
    sp = results["speedup"]
    if sp["cores"] >= 2:
        return (f"speedup {sp['speedup']:.2f}x "
                f"(gate >= {min_speedup:g}x, jobs={sp['jobs']}, "
                f"cores={sp['cores']})")
    return (f"speedup {sp['speedup']:.2f}x measured on a single-core "
            f"host — gate >= {min_speedup:g}x SKIPPED (no parallel "
            f"hardware; pool overhead with no parallelism is the "
            f"expected < 1x)")


def make_baseline(results: Dict) -> Dict:
    """Committed baseline: pins the op streams (deterministic) and
    records this machine's measured rates/topology for the perf
    trajectory (informational)."""
    sp = results["speedup"]
    return {
        "format": CORPUS_BASELINE_FORMAT,
        "version": CORPUS_BENCH_VERSION,
        "size": results["size"],
        "seed": results["seed"],
        "corpus_entries": results["corpus"]["entries"],
        "corpus_n_ops": results["corpus"]["n_ops"],
        "sweep_n_ops": sp["n_ops"],
        "machine": {
            "cores": sp["cores"],
            "jobs": sp["jobs"],
            "speedup": sp["speedup"],
            "serial_ops_per_s": sp["serial_ops_per_s"],
            "parallel_ops_per_s": sp["parallel_ops_per_s"],
        },
    }


def compare_to_baseline(results: Dict, baseline: Dict,
                        min_speedup: float) -> List[str]:
    failures = gate_failures(results, min_speedup)
    if baseline.get("format") != CORPUS_BASELINE_FORMAT:
        failures.append("baseline file has the wrong format marker")
        return failures
    for key, got in (("corpus_entries", results["corpus"]["entries"]),
                     ("corpus_n_ops", results["corpus"]["n_ops"]),
                     ("sweep_n_ops", results["speedup"]["n_ops"])):
        pinned = baseline.get(key)
        if pinned is not None and pinned != got:
            failures.append(
                f"op-stream pin {key}: baseline {pinned}, run {got} "
                f"(scenario/corpus drift — regenerate baselines only "
                f"for intentional changes)")
    return failures
