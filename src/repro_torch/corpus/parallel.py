"""Parallel sharded replay: fan a v3 trace out across worker processes.

The batched streaming replayer already decodes chunks into independent
per-rank engine segments, and ``CounterRegistry(lanes_only=True)`` lanes
are mergeable columnar deltas — so a trace *partitions*:

  * ``partition="rank"`` (the fast path): every rank's
    :class:`~repro_torch.match.MatchEngine` is fully independent, so shards
    replay disjoint rank subsets of the same stream and the per-phase
    rank→stats maps union back together exactly. Shards are planned by
    greedy op-count balancing from a cheap
    :func:`~repro_torch.trace.replay.scan_partition` pre-scan. Near-linear in
    rank count; degenerate (one shard) for single-rank traces.
  * ``partition="phase"`` (the alternative for low-rank traces): shards
    own contiguous phase ranges. Engine state legitimately crosses phase
    boundaries (leaked UMQ entries, straddling posted receives), so each
    shard drives its warmup prefix with counters disabled before
    recording its range — correct for every mode, but the warmup is
    serial work, so speedup is bounded by phase position (~2× at best).

Both produce a merged :class:`~repro_torch.trace.replay.ReplayResult` that is
stat- and finding-identical to serial ``replay(path,
check_matches=False)`` — the property ``tests/test_corpus.py`` pins and
``benchmarks/corpus_bench.py`` gates.

Workers are spawn-safe: :data:`ReplayPool` uses the ``spawn`` start
method (no fork-inherited state, works under any host), and shard tasks
are plain tuples dispatched to the module-level :func:`shard_worker`.
Worker startup pays the package import (~0.5 s), so pools are meant to
be created once and reused across traces — the corpus runner and the
benches all thread one pool through every call.

A copy of ``repro.corpus.parallel``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.counters import reduce_lanes
from ..trace.replay import (PartitionScan, Replayer, ReplayResult,
                            scan_partition)
from .codec import decode_phases, encode_shard, result_from_phases

PARTITIONS = ("rank", "phase")


def usable_cores() -> int:
    """CPU cores this process may actually schedule on (affinity-aware;
    the honest input to "is a parallel speedup even possible here")."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        return max(1, os.cpu_count() or 1)


def default_jobs() -> int:
    return usable_cores()


# -- shard planning --------------------------------------------------------

# Below this many ops a shard is dispatch-dominated (pickle + IPC +
# per-shard header parse cost ~ the replay itself), so tiny traces are
# planned into fewer, meatier shards rather than one-per-job.
MIN_SHARD_OPS = 256
# Planning more shards than cores can schedule only helps load
# balancing up to a point; beyond ~4 shards per usable core the extra
# dispatch overhead outweighs it.
_OVERSHARD = 4


def _shard_budget(scan: PartitionScan, jobs: int, cores: Optional[int],
                  min_shard_ops: int) -> int:
    if cores is None:
        cores = usable_cores()
    budget = min(jobs, max(1, cores) * _OVERSHARD)
    if min_shard_ops > 0:
        budget = min(budget, max(1, scan.n_ops // min_shard_ops))
    return max(1, budget)


def plan_shards(scan: PartitionScan, jobs: int, partition: str = "rank",
                cores: Optional[int] = None,
                min_shard_ops: int = MIN_SHARD_OPS
                ) -> List[Tuple[str, Tuple]]:
    """Plan at most ``jobs`` shards over a scanned trace. Returns
    ``("rank", (r0, r1, ...))`` or ``("phase", (lo, hi))`` specs;
    deterministic for a given scan (and a given ``cores``: pass it
    explicitly for host-independent plans — it defaults to
    :func:`usable_cores` so single-core hosts don't pay sharding
    overhead they can't recoup). ``min_shard_ops`` batches small
    traces into fewer, meatier shards; 0 disables the floor."""
    if partition == "rank":
        # greedy balance: heaviest ranks first onto the lightest shard
        ranks = sorted(scan.rank_ops, key=lambda r: (-scan.rank_ops[r], r))
        nsh = max(1, min(_shard_budget(scan, jobs, cores, min_shard_ops),
                         len(ranks)))
        bins: List[List[int]] = [[] for _ in range(nsh)]
        loads = [0] * nsh
        for r in ranks:
            i = loads.index(min(loads))
            bins[i].append(r)
            loads[i] += scan.rank_ops[r]
        return [("rank", tuple(sorted(b))) for b in bins if b]
    if partition == "phase":
        nsh = max(1, min(_shard_budget(scan, jobs, cores, min_shard_ops),
                         scan.n_phases))
        base, rem = divmod(scan.n_phases, nsh)
        out: List[Tuple[str, Tuple]] = []
        lo = 0
        for i in range(nsh):
            hi = lo + base + (1 if i < rem else 0)
            out.append(("phase", (lo, hi)))
            lo = hi
        return out
    raise ValueError(f"partition must be one of {PARTITIONS}, "
                     f"got {partition!r}")


# -- worker ----------------------------------------------------------------

def shard_worker(task: Tuple) -> Dict:
    """Replay one shard (or, with both filters ``None``, the whole
    trace) and return the encoded result. Module-level so the spawn
    pool can import-and-call it; plain containers in and out so pickle
    stays cheap."""
    path, mode, progress_mode, ranks, phase_range = task
    rep = Replayer(mode=mode, progress_mode=progress_mode,
                   check_matches=False, ranks=ranks,
                   phase_range=tuple(phase_range) if phase_range else None)
    return encode_shard(rep.run(path))


# -- pools -----------------------------------------------------------------

class InlinePool:
    """Same ``map`` surface as :class:`ReplayPool`, run in-process.
    The zero-subprocess fallback: single-core hosts, tests that need
    determinism without spawn cost, and ``jobs=1`` baselines still
    exercise the exact shard/merge code path."""

    jobs = 1

    def map(self, fn, tasks: Sequence) -> List:
        return [fn(t) for t in tasks]

    def close(self) -> None:
        pass

    def __enter__(self) -> "InlinePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ReplayPool:
    """A persistent spawn-context worker pool for sharded replay.

    Spawn (not fork) so workers start from a clean interpreter —
    thread-safe under the telemetry bridge's daemon threads and
    identical across platforms. Reuse one pool across many
    ``parallel_replay`` / corpus-runner calls to amortize the per-worker
    interpreter + import startup."""

    def __init__(self, jobs: Optional[int] = None,
                 start_method: str = "spawn"):
        self.jobs = max(1, jobs if jobs is not None else default_jobs())
        self._pool = mp.get_context(start_method).Pool(self.jobs)

    def map(self, fn, tasks: Sequence) -> List:
        tasks = list(tasks)
        # batch small tasks per worker dispatch: one IPC round per
        # ~2 chunks per worker instead of one per shard, order
        # preserved by Pool.map regardless of chunksize
        chunk = max(1, len(tasks) // (self.jobs * 2))
        return self._pool.map(fn, tasks, chunksize=chunk)

    def close(self) -> None:
        self._pool.close()
        self._pool.join()

    def terminate(self) -> None:
        self._pool.terminate()

    def __enter__(self) -> "ReplayPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- merge -----------------------------------------------------------------

def merge_shards(parts: Sequence[Dict], partition: str = "rank"
                 ) -> ReplayResult:
    """Reduce encoded shard results into one :class:`ReplayResult`.

    Rank shards all carry the full phase skeleton (and identical wall
    spans — every shard parses every stamp); their per-phase rank→stats
    maps are disjoint unions, and shard 0 is the timekeeper for aux
    streams. Phase shards carry disjoint phase ranges; concatenation in
    range order *is* the serial phase list, and aux streams were
    range-gated in the workers."""
    if not parts:
        raise ValueError("merge_shards: no shard results")
    first = parts[0]
    n_ops = sum(p["n_ops"] for p in parts)
    decoded = [decode_phases(p["phases"]) for p in parts]
    if partition == "rank":
        skel = [(ph.index, ph.label, ph.op) for ph in decoded[0]]
        for d in decoded[1:]:
            if [(ph.index, ph.label, ph.op) for ph in d] != skel:
                raise ValueError(
                    "rank shards disagree on the phase skeleton "
                    "(trace changed under the pool?)")
        phases = decoded[0]
        for i, ph in enumerate(phases):
            ph.stats = reduce_lanes([d[i].stats for d in decoded])
        pe = first["pe"]
        snap = first["snap"]
    elif partition == "phase":
        phases = [ph for d in decoded for ph in d]
        phases.sort(key=lambda ph: ph.index)
        pe = [r for p in parts for r in p["pe"]]
        snap = next((p["snap"] for p in parts
                     if p["snap"] is not None), None)
    else:
        raise ValueError(f"partition must be one of {PARTITIONS}, "
                         f"got {partition!r}")
    progress_mode = next(
        (p["progress_mode"] for p in parts if p["progress_mode"]), None)
    res = result_from_phases(
        [], mode=first["mode"], progress_mode=progress_mode,
        header=first["header"], pe_records=pe, raw_snap=snap,
        n_ops=n_ops)
    # phases are already decoded here — no codec round-trip
    res.phases = phases
    return res


# -- entry point -----------------------------------------------------------

def parallel_replay(source: Union[str, "os.PathLike"],
                    mode: Optional[str] = None,
                    progress_mode: Optional[str] = None,
                    jobs: Optional[int] = None,
                    partition: str = "rank",
                    pool: Optional[Union[ReplayPool, InlinePool]] = None
                    ) -> ReplayResult:
    """Sharded replay of one trace; drop-in for
    ``replay(path, mode=..., check_matches=False)``.

    ``jobs`` bounds the shard count (default: usable cores); ``pool``
    reuses a persistent :class:`ReplayPool` (or :class:`InlinePool`)
    across calls — without one, multi-shard plans spin up an ephemeral
    spawn pool and single-shard plans run inline."""
    path = str(source)
    scan = scan_partition(path)
    if jobs is None:
        jobs = pool.jobs if pool is not None else default_jobs()
    shards = plan_shards(scan, jobs, partition)
    tasks = [(path, mode, progress_mode,
              spec if kind == "rank" else None,
              spec if kind == "phase" else None)
             for kind, spec in shards]
    if pool is not None and len(tasks) > 1:
        parts = pool.map(shard_worker, tasks)
    elif len(tasks) > 1:
        with ReplayPool(jobs=min(jobs, len(tasks))) as p:
            parts = p.map(shard_worker, tasks)
    else:
        parts = [shard_worker(t) for t in tasks]
    return merge_shards(parts, partition)
