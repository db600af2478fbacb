"""Counter/histogram registry — the data substrate of profiling method 2.

The paper's second method instruments the MPI implementation's *message-
matching engine* with lightweight counters (queue depth traversed, queue
length, unexpected-message counts) instead of timeline regions. This
registry is the hot-path sink for those counters, built in the same
second-queue style as :class:`repro_torch.core.collector.Collector`: producer
threads append flat ``pid, name, value, is_observation`` delta quads to
**thread-local** buffers (one atomic ``extend`` per op in CPython — no
shared lock on the hot path); the reader swaps its own buffer out under
the registry lock, consumes foreign threads' buffers in place, and
bulk-merges into aggregate statistics on its own time. Producers never
contend with the consumer, so instrumenting the matching engine does not
perturb the matching engine — the property the paper calls out as
essential for counters inside the critical path.

Snapshots serialize into :class:`repro_torch.core.events.Event`-compatible
records (category ``"counter"``, zero duration, stats in ``attrs``) so the
existing timeline export, GraphFrame aggregation and automated analyses
all work on counter data unchanged.

One registry can carry multiple *lanes* (:meth:`CounterRegistry.lane`):
per-pid views sharing the same thread-local buffers and drain machinery,
so a :class:`repro_torch.match.Fabric` records one lane per rank and snapshots
render one timeline track per rank while :meth:`CounterRegistry.drain`
still returns the cross-rank aggregate.

A copy of ``repro.core.counters``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time
from itertools import islice
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as _np

from .events import Event

COUNTER_CATEGORY = "counter"
COUNTER_PREFIX = "counter/"

# Delta records are stored FLAT: every buffered delta is four consecutive
# list elements ``pid, name, value, is_observation``. Counters accumulate
# value; observations additionally feed min/max and the power-of-two
# histogram; pid tags the lane the delta belongs to. The flat encoding
# exists for the producer side: appending one op's deltas is a single
# ``buf += (pid, name, value, obs, pid, name2, ...)`` — one tuple
# allocation and one extend instead of one tuple per delta (~3x cheaper
# on the matching hot path). The drain regroups with ``zip(it, it, it,
# it)``.
#
# Batch producers (the match engine's batched dispatch) go one step
# further with COLUMN records: one quad ``pid, spec, rows, "cols"``
# carries a whole batch of same-shaped deltas, where ``spec`` is a tuple
# of ``(name, is_observation)`` columns and ``rows`` is the flat
# row-major value list (len(rows) % len(spec) == 0). The delta multiset
# is exactly the per-delta expansion — recording cost per op drops to
# one small tuple-extend, and the drain resolves each column's stat once
# per record instead of once per delta.
_Delta = Tuple[int, str, float, bool]
DELTA_WIDTH = 4
COLS = "cols"


def _pow2_bin(value: float) -> int:
    """Lower bound of the power-of-two bucket holding ``value``
    (0 -> 0, 1 -> 1, 2..3 -> 2, 4..7 -> 4, ...)."""
    v = int(value)
    if v <= 0:
        return 0
    return 1 << (v.bit_length() - 1)


@dataclasses.dataclass(**({"slots": True} if sys.version_info >= (3, 10)
                           else {}))
class CounterStat:
    """Merged statistics for one named counter or histogram (slotted
    where the runtime allows: the drain's per-delta attribute updates
    are the hottest consumer-side loop in the repo)."""

    name: str
    kind: str = "counter"            # "counter" | "histogram"
    count: int = 0                   # number of increments / observations
    total: float = 0.0               # sum of values
    vmin: float = math.inf
    vmax: float = -math.inf
    bins: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def add(self, value: float, observation: bool) -> None:
        self.count += 1
        self.total += value
        if observation:
            self.kind = "histogram"
            self.vmin = min(self.vmin, value)
            self.vmax = max(self.vmax, value)
            b = _pow2_bin(value)
            self.bins[b] = self.bins.get(b, 0) + 1

    def merge(self, other: "CounterStat") -> None:
        self.count += other.count
        self.total += other.total
        if other.kind == "histogram":
            self.kind = "histogram"
            self.vmin = min(self.vmin, other.vmin)
            self.vmax = max(self.vmax, other.vmax)
            for b, c in other.bins.items():
                self.bins[b] = self.bins.get(b, 0) + c

    def to_attrs(self) -> Dict[str, object]:
        """JSON-serializable attrs payload for an Event record."""
        out: Dict[str, object] = {
            "counter": self.name,
            "kind": self.kind,
            "count": self.count,
            "total": self.total,
            "mean": self.mean if self.count else 0.0,
        }
        if self.kind == "histogram" and self.count:
            out["min"] = self.vmin
            out["max"] = self.vmax
            out["bins"] = {str(b): c for b, c in sorted(self.bins.items())}
        return out

    @staticmethod
    def from_attrs(attrs: Dict[str, object]) -> "CounterStat":
        st = CounterStat(name=str(attrs["counter"]),
                         kind=str(attrs.get("kind", "counter")),
                         count=int(attrs.get("count", 0)),
                         total=float(attrs.get("total", 0.0)))
        if "min" in attrs:
            st.vmin = float(attrs["min"])          # type: ignore[arg-type]
        if "max" in attrs:
            st.vmax = float(attrs["max"])          # type: ignore[arg-type]
        for b, c in (attrs.get("bins") or {}).items():  # type: ignore[union-attr]
            st.bins[int(b)] = int(c)
        return st


class CounterLane:
    """Per-pid view of a registry: shares the registry's thread-local
    buffers (and therefore its lock-free hot path), but tags every delta
    with this lane's pid so per-rank statistics survive the merge."""

    __slots__ = ("_reg", "pid")

    def __init__(self, registry: "CounterRegistry", pid: int):
        self._reg = registry
        self.pid = pid

    @property
    def enabled(self) -> bool:
        return self._reg.enabled

    def count(self, name: str, value: float = 1) -> None:
        if self._reg.enabled:
            self._reg._buffer_for_current_thread().extend(
                (self.pid, name, value, False))

    def observe(self, name: str, value: float) -> None:
        if self._reg.enabled:
            self._reg._buffer_for_current_thread().extend(
                (self.pid, name, value, True))

    def observe_many(self, name: str, values: Iterable[float]) -> None:
        """Batched observations: one buffer fetch, one extend."""
        if self._reg.enabled:
            pid = self.pid
            buf = self._reg._buffer_for_current_thread()
            for v in values:
                buf += (pid, name, v, True)

    def buffer(self) -> List:
        """This thread's flat delta buffer, for hot-path producers that
        batch their own ``pid, name, value, is_observation`` quads (see
        :meth:`CounterRegistry.buffer`). Use :attr:`pid` as the lane tag
        and check :attr:`enabled` first."""
        return self._reg._buffer_for_current_thread()


def _fresh_stat(name: str) -> CounterStat:
    """Bare-metal CounterStat construction for the drain: the dataclass
    ``__init__`` costs ~3x this at the volume per-phase snapshots create
    stats (every snapshot clears and every drain recreates)."""
    st = CounterStat.__new__(CounterStat)
    st.name = name
    st.kind = "counter"
    st.count = 0
    st.total = 0.0
    st.vmin = math.inf
    st.vmax = -math.inf
    st.bins = {}
    return st


class CounterRegistry:
    """Thread-safe, low-overhead counter sink (drain-on-read).

    ``lanes_only=True`` drops the cross-lane aggregate: the drain
    maintains per-pid lane statistics only and :meth:`drain` returns
    ``{}``. The batched trace replayer uses this — it consumes lanes
    exclusively (one per replayed rank, snapshotted every phase), so
    maintaining the aggregate would double the merge work for a dict
    nobody reads."""

    def __init__(self, pid: int = 0, lanes_only: bool = False):
        self.pid = pid
        self.lanes_only = lanes_only
        self._registry_lock = threading.Lock()   # cold path only
        # serializes *consumers* (drain/snapshot callers) against each
        # other: a live telemetry poller and the run's own end-of-phase
        # drain may race, and the merge phase mutates shared stat dicts.
        # Producers never touch this lock — the hot path stays lock-free.
        self._drain_lock = threading.Lock()
        self._buffers: Dict[int, List] = {}      # flat quads per thread
        self._merged: Dict[str, CounterStat] = {}
        # per-lane stats, nested pid -> name -> stat (tuple keys would
        # cost one allocation per merged delta)
        self._merged_by_pid: Dict[int, Dict[str, CounterStat]] = {}
        self._lanes: Dict[int, CounterLane] = {}
        self.enabled = True
        # bumped whenever a drain may have swapped a buffer out, so
        # producers that cache the buffer reference (MatchEngine) know
        # to refetch; plain int read on the hot path
        self.epoch = 0
        # drain-epoch accounting (cumulative over the registry's life):
        # completed drains and logical deltas merged (column records
        # expanded) — with these, concurrent pollers can assert no-loss
        # delta accounting (sum of snapshot deltas == deltas_merged)
        self.drains = 0
        self.deltas_merged = 0

    # -- producer side (hot path, lock-free after first call per thread) --

    def _buffer_for_current_thread(self) -> List[_Delta]:
        ident = threading.get_ident()
        buf = self._buffers.get(ident)
        if buf is None:
            with self._registry_lock:
                buf = self._buffers.setdefault(ident, [])
        return buf

    def count(self, name: str, value: float = 1) -> None:
        """Monotonic counter increment."""
        if self.enabled:
            self._buffer_for_current_thread().extend(
                (self.pid, name, value, False))

    def observe(self, name: str, value: float) -> None:
        """Histogram observation (feeds min/max and power-of-two bins)."""
        if self.enabled:
            self._buffer_for_current_thread().extend(
                (self.pid, name, value, True))

    def observe_many(self, name: str, values: Iterable[float]) -> None:
        """Batched observations of one (ideally interned/literal) name:
        one buffer fetch instead of a call per value."""
        if self.enabled:
            pid = self.pid
            buf = self._buffer_for_current_thread()
            for v in values:
                buf += (pid, name, v, True)

    def buffer(self) -> List:
        """This thread's flat delta buffer, for hot-path producers (the
        match engine) that batch one op's deltas into a single
        ``buf += (pid, name, value, is_observation, pid, name2, ...)``.
        Callers must check :attr:`enabled` first, tag quads with the
        producer's pid, and use interned or literal strings for names
        (the drain hashes each name once per delta). A fetched buffer
        stays appendable across *other* threads' drains (they consume in
        place), but a drain on the fetching thread swaps it out —
        producers that cache the reference must refetch whenever
        :attr:`epoch` changes."""
        return self._buffer_for_current_thread()

    def lane(self, pid: int) -> CounterLane:
        """Per-pid producer view (one lane per rank; cached)."""
        lane = self._lanes.get(pid)
        if lane is None:
            with self._registry_lock:
                lane = self._lanes.setdefault(pid, CounterLane(self, pid))
        return lane

    # -- consumer side --

    def _merge(self, flat: Iterable) -> None:
        """Fold one batch of flat delta quads into the aggregate and
        per-lane stats. :meth:`CounterStat.add` is inlined — at drain
        volume the method dispatch and the `_pow2_bin` call are the
        cost."""
        merged = self._merged
        by_pid = self._merged_by_pid
        pairs: Dict[int, Dict[str, tuple]] = {}   # pid -> name -> pair
        cpid = None
        cpairs: Dict[str, tuple] = {}
        nd = 0                            # logical deltas this batch
        it = iter(flat)
        for pid, name, value, obs in zip(it, it, it, it):
            if type(obs) is str:          # column record: name=spec,
                nd += len(value)          # value=row-major values
                per = by_pid.get(pid)
                if per is None:
                    per = by_pid[pid] = {}
                if len(value) >= 24:
                    # long record: aggregate each column with C-level
                    # slicing, distinct-value counting (queue metrics
                    # repeat heavily) and one bin pass over distinct
                    # values, applied ONCE per stat — the per-value
                    # double stat update is the drain's (and the batched
                    # replayer's) dominant cost at volume
                    k = len(name)
                    j = 0
                    for cname, cobs in name:
                        colv = value[j::k] if k > 1 else value
                        j += 1
                        cnt = len(colv)
                        tot = sum(colv)
                        st = merged.get(cname)
                        if st is None:
                            st = merged[cname] = _fresh_stat(cname)
                        pst = per.get(cname)
                        if pst is None:
                            pst = per[cname] = _fresh_stat(cname)
                        st.count += cnt
                        st.total += tot
                        pst.count += cnt
                        pst.total += tot
                        if cobs:
                            vc: Dict[float, int] = {}
                            vget = vc.get
                            for v in colv:
                                vc[v] = vget(v, 0) + 1
                            mn = min(vc)
                            mx = max(vc)
                            st.kind = "histogram"
                            if mn < st.vmin:
                                st.vmin = mn
                            if mx > st.vmax:
                                st.vmax = mx
                            pst.kind = "histogram"
                            if mn < pst.vmin:
                                pst.vmin = mn
                            if mx > pst.vmax:
                                pst.vmax = mx
                            sbins = st.bins
                            sget = sbins.get
                            pbins = pst.bins
                            pget = pbins.get
                            for v, c in vc.items():
                                iv = int(v)
                                b = (1 << (iv.bit_length() - 1)
                                     if iv > 0 else 0)
                                sbins[b] = sget(b, 0) + c
                                pbins[b] = pget(b, 0) + c
                    continue
                # short record: the per-value loop's fixed cost wins
                cols = []
                for cname, cobs in name:
                    st = merged.get(cname)
                    if st is None:
                        st = merged[cname] = _fresh_stat(cname)
                    pst = per.get(cname)
                    if pst is None:
                        pst = per[cname] = _fresh_stat(cname)
                    cols.append((st, pst, cobs))
                k = len(cols)
                i = 0
                for v in value:
                    st, pst, cobs = cols[i]
                    i += 1
                    if i == k:
                        i = 0
                    st.count += 1
                    st.total += v
                    pst.count += 1
                    pst.total += v
                    if cobs:
                        iv = int(v)
                        b = 1 << (iv.bit_length() - 1) if iv > 0 else 0
                        st.kind = "histogram"
                        if v < st.vmin:
                            st.vmin = v
                        if v > st.vmax:
                            st.vmax = v
                        bins = st.bins
                        bins[b] = bins.get(b, 0) + 1
                        pst.kind = "histogram"
                        if v < pst.vmin:
                            pst.vmin = v
                        if v > pst.vmax:
                            pst.vmax = v
                        bins = pst.bins
                        bins[b] = bins.get(b, 0) + 1
                continue
            # flat quad: consecutive deltas overwhelmingly share the
            # producing lane, so the (aggregate, lane) stat pair is
            # resolved through a per-pid cache — one dict get per delta
            # instead of three
            nd += 1
            if pid != cpid:
                cpid = pid
                cpairs = pairs.get(pid)
                if cpairs is None:
                    cpairs = pairs[pid] = {}
            pair = cpairs.get(name)
            if pair is None:
                st = merged.get(name)
                if st is None:
                    st = merged[name] = _fresh_stat(name)
                per = by_pid.get(pid)
                if per is None:
                    per = by_pid[pid] = {}
                pst = per.get(name)
                if pst is None:
                    pst = per[name] = _fresh_stat(name)
                pair = cpairs[name] = (st, pst)
            else:
                st, pst = pair
            st.count += 1
            st.total += value
            pst.count += 1
            pst.total += value
            if obs:
                v = int(value)
                b = 1 << (v.bit_length() - 1) if v > 0 else 0
                st.kind = "histogram"
                if value < st.vmin:
                    st.vmin = value
                if value > st.vmax:
                    st.vmax = value
                bins = st.bins
                bins[b] = bins.get(b, 0) + 1
                pst.kind = "histogram"
                if value < pst.vmin:
                    pst.vmin = value
                if value > pst.vmax:
                    pst.vmax = value
                bins = pst.bins
                bins[b] = bins.get(b, 0) + 1
        self.deltas_merged += nd

    def _merge_lanes(self, flat: Iterable) -> None:
        """:meth:`_merge` for ``lanes_only`` registries: identical fold,
        per-lane stats only — no cross-lane aggregate maintenance. Kept
        as a separate inlined loop so neither variant pays a per-delta
        branch (the file's usual hot-loop duplication trade).

        Column records are *grouped* before folding: one batch (one
        per-phase drain, on the replay path) typically carries many tiny
        records sharing the same lane and column-set constant (one per
        engine batch call), and stat folding is commutative — so same-
        ``(pid, columns)`` value lists are concatenated first and each
        combined column set folds once, long enough to take the bulk
        fold paths tiny records never reach."""
        by_pid = self._merged_by_pid
        cpid = None
        cper: Dict[str, CounterStat] = {}
        nd = 0                            # logical deltas this batch
        groups: Dict[Tuple[int, int], List] = {}
        it = iter(flat)
        for pid, name, value, obs in zip(it, it, it, it):
            if pid != cpid:
                cpid = pid
                cper = by_pid.get(pid)
                if cper is None:
                    cper = by_pid[pid] = {}
            per = cper
            if type(obs) is str:          # column record: defer, grouped
                g = groups.get((pid, id(name)))
                if g is None:
                    groups[(pid, id(name))] = [per, name, list(value)]
                else:
                    g[2] += value
                continue
            pst = per.get(name)
            if pst is None:
                pst = per[name] = _fresh_stat(name)
            nd += 1
            pst.count += 1
            pst.total += value
            if obs:
                v = int(value)
                b = 1 << (v.bit_length() - 1) if v > 0 else 0
                pst.kind = "histogram"
                if value < pst.vmin:
                    pst.vmin = value
                if value > pst.vmax:
                    pst.vmax = value
                bins = pst.bins
                bins[b] = bins.get(b, 0) + 1
        for per, name, value in groups.values():
            nd += self._fold_cols(per, name, value)
        self.deltas_merged += nd

    @staticmethod
    def _fold_cols(per: Dict[str, CounterStat], name, value) -> int:
        """Fold one (possibly concatenated) column record into a lane's
        stats; returns the number of logical deltas folded. Same three
        tiers as :meth:`_merge`'s inline fold: numpy bulk, python
        column slices, tiny per-value loop."""
        nv = len(value)
        a = None
        if nv >= 96:
            try:
                a = _np.asarray(value)
            except (OverflowError, ValueError):
                a = None
            if a is not None and a.dtype != _np.int64:
                a = None              # floats/bignums: exact python fold
        if a is not None:
            # numpy bulk fold: column sums/extrema and the
            # power-of-two bin counts (frexp exponent ==
            # bit_length) in a handful of vector ops — engine
            # queue metrics are small ints, exact in float64
            k = len(name)
            a = a.reshape(-1, k) if k > 1 else a[:, None]
            j = 0
            for cname, cobs in name:
                col = a[:, j]
                j += 1
                pst = per.get(cname)
                if pst is None:
                    pst = per[cname] = _fresh_stat(cname)
                pst.count += len(col)
                pst.total += int(col.sum())
                if cobs:
                    mn = int(col.min())
                    mx = int(col.max())
                    pst.kind = "histogram"
                    if mn < pst.vmin:
                        pst.vmin = mn
                    if mx > pst.vmax:
                        pst.vmax = mx
                    pbins = pst.bins
                    pget = pbins.get
                    pos = col[col > 0]
                    nz = len(pos)
                    if nz != len(col):
                        pbins[0] = pget(0, 0) + len(col) - nz
                    if nz:
                        exps = _np.frexp(
                            pos.astype(_np.float64))[1] - 1
                        bv, bc = _np.unique(
                            exps, return_counts=True)
                        for e, cco in zip(bv.tolist(),
                                          bc.tolist()):
                            bb = 1 << e
                            pbins[bb] = pget(bb, 0) + cco
            return nv
        if nv >= 24:
            k = len(name)
            j = 0
            for cname, cobs in name:
                colv = value[j::k] if k > 1 else value
                j += 1
                pst = per.get(cname)
                if pst is None:
                    pst = per[cname] = _fresh_stat(cname)
                pst.count += len(colv)
                pst.total += sum(colv)
                if cobs:
                    vc: Dict[float, int] = {}
                    vget = vc.get
                    for v in colv:
                        vc[v] = vget(v, 0) + 1
                    mn = min(vc)
                    mx = max(vc)
                    pst.kind = "histogram"
                    if mn < pst.vmin:
                        pst.vmin = mn
                    if mx > pst.vmax:
                        pst.vmax = mx
                    pbins = pst.bins
                    pget = pbins.get
                    for v, c in vc.items():
                        iv = int(v)
                        b = (1 << (iv.bit_length() - 1)
                             if iv > 0 else 0)
                        pbins[b] = pget(b, 0) + c
            return nv
        cols = []
        for cname, cobs in name:
            pst = per.get(cname)
            if pst is None:
                pst = per[cname] = _fresh_stat(cname)
            cols.append((pst, cobs))
        k = len(cols)
        i = 0
        for v in value:
            pst, cobs = cols[i]
            i += 1
            if i == k:
                i = 0
            pst.count += 1
            pst.total += v
            if cobs:
                iv = int(v)
                b = 1 << (iv.bit_length() - 1) if iv > 0 else 0
                pst.kind = "histogram"
                if v < pst.vmin:
                    pst.vmin = v
                if v > pst.vmax:
                    pst.vmax = v
                bins = pst.bins
                bins[b] = bins.get(b, 0) + 1
        return nv

    def drain(self) -> Dict[str, CounterStat]:
        """Merge all buffered deltas into the aggregate stats and return
        the full aggregate (same snapshot-and-clear idiom as Collector).
        Lane structure is preserved in parallel for :meth:`drain_lanes`.
        A ``lanes_only`` registry maintains the lanes alone and returns
        ``{}`` here.

        Buffers owned by the draining thread are swapped out whole under
        the registry lock (no copy, no delete — the common case: single-
        threaded benches and scenario runs drain their own buffer).
        Buffers of *other* live threads cannot be swapped without racing
        their lock-free ``fetch buffer -> append`` window, so those are
        consumed in place with the atomic idiom the producers rely on:
        read ``[0, n)`` (appends only ever land at the tail) and then
        drop the consumed prefix with a single atomic ``del``.

        Concurrent *consumers* (a live telemetry poller racing the
        run's own drain) are serialized on a consumer-side lock; the
        producer hot path never touches it."""
        with self._drain_lock:
            return self._drain_consume()

    def _drain_consume(self) -> Dict[str, CounterStat]:
        """The drain body; callers hold ``_drain_lock``."""
        me = threading.get_ident()
        own: List[List] = []
        foreign: List[Tuple[List, int]] = []
        with self._registry_lock:
            self.epoch += 1
            for ident, buf in list(self._buffers.items()):
                if not buf:
                    continue
                if ident == me:
                    self._buffers[ident] = []
                    own.append(buf)
                else:
                    # quad-align: a foreign producer may be mid-extend
                    foreign.append((buf, len(buf) // 4 * 4))
        merge = self._merge_lanes if self.lanes_only else self._merge
        for buf in own:
            merge(buf)
        for buf, n in foreign:
            merge(islice(buf, n))
            del buf[:n]
        self.drains += 1
        return dict(self._merged)

    def pending_deltas(self) -> int:
        """Logical deltas buffered but not yet drained, column records
        expanded (cold-path metric; the hotpath bench reports drain
        throughput in deltas/sec)."""
        total = 0
        with self._registry_lock:
            for buf in self._buffers.values():
                it = iter(buf)
                for _pid, name, value, obs in zip(it, it, it, it):
                    total += len(value) if type(obs) is str else 1
        return total

    def drain_stats(self) -> Dict[str, int]:
        """Drain-epoch accounting: the current ``epoch``, completed
        ``drains``, cumulative logical ``deltas_merged`` (column records
        expanded — the same unit :meth:`pending_deltas` counts) and the
        deltas still ``pending`` in producer buffers. ``deltas_merged +
        pending`` is every delta ever recorded, so two concurrent
        consumers can assert no-loss accounting."""
        return {"epoch": self.epoch, "drains": self.drains,
                "deltas_merged": self.deltas_merged,
                "pending": self.pending_deltas()}

    def drain_lanes(self) -> Dict[int, Dict[str, CounterStat]]:
        """Per-pid statistics (drains first). The aggregate returned by
        :meth:`drain` is the merge of these lanes."""
        with self._drain_lock:
            self._drain_consume()
            return {pid: dict(per)
                    for pid, per in self._merged_by_pid.items()}

    def value(self, name: str) -> float:
        """Total of one counter (drains first, aggregated across lanes)."""
        st = self.drain().get(name)
        return st.total if st else 0.0

    def clear(self) -> None:
        with self._registry_lock:
            for buf in self._buffers.values():
                del buf[:]
            self._merged.clear()
            self._merged_by_pid.clear()

    # -- Event bridge ------------------------------------------------------

    def snapshot_lanes(self) -> Dict[int, Dict[str, CounterStat]]:
        """Drain and return the per-lane statistics accumulated since
        the previous snapshot, clearing the merged aggregates — the
        stat-level sibling of :meth:`snapshot_events` (same snapshot-
        and-clear delta semantics, no Event round-trip). The batched
        trace replayer's streaming phase flush consumes this directly:
        one dict per lane instead of one Event + attrs-encode + attrs-
        parse per (lane, counter). Ownership of the returned lane dicts
        transfers to the caller (the registry starts fresh ones), so a
        per-phase snapshot costs no copying."""
        with self._drain_lock:
            self._drain_consume()
            with self._registry_lock:
                lanes = self._merged_by_pid
                self._merged = {}
                self._merged_by_pid = {}
        return lanes

    def snapshot(self) -> Dict[str, object]:
        """One delta snapshot with drain-epoch metadata: ``{"lanes":
        {pid: {name: CounterStat}}, "meta": {"epoch", "drains",
        "deltas_merged", "pending"}}``. Lanes are the
        :meth:`snapshot_lanes` delta (ownership transfers); the meta
        counters are cumulative, so a poller chain can assert no-loss
        accounting across concurrent drains: the sum of delta counts
        over every snapshot ever taken equals ``deltas_merged`` (and
        ``pending`` names what is still buffered). The live telemetry
        bridge polls this."""
        with self._drain_lock:
            self._drain_consume()
            with self._registry_lock:
                lanes = self._merged_by_pid
                self._merged = {}
                self._merged_by_pid = {}
            meta = {"epoch": self.epoch, "drains": self.drains,
                    "deltas_merged": self.deltas_merged}
        meta["pending"] = self.pending_deltas()
        return {"lanes": lanes, "meta": meta}

    def snapshot_events(self, t_ns: Optional[int] = None,
                        path_root: str = "counters") -> List[Event]:
        """Serialize everything since the previous snapshot as zero-duration
        Events so the timeline/graphframe/analyses machinery can consume
        counter data. Snapshot-and-clear: each call emits a *delta*, so
        periodic snapshots of one registry merge additively in
        :func:`counter_stats` without double-counting (same reason the
        paper's counters are drained, not read, per interval). Lane deltas
        keep their pid, so per-rank lanes come out as separate timeline
        tracks."""
        return lane_events(self.snapshot_lanes(), t_ns=t_ns,
                           path_root=path_root)


def lane_events(lanes: Dict[int, Dict[str, CounterStat]],
                t_ns: Optional[int] = None,
                path_root: str = "counters") -> List[Event]:
    """Serialize per-pid lane statistics as the zero-duration counter
    Events :meth:`CounterRegistry.snapshot_events` emits (same names,
    paths, ordering and attrs) — shared by the registry and by consumers
    that accumulate lane deltas elsewhere (the telemetry bridge), so
    detector findings are identical however the stats traveled."""
    t = t_ns if t_ns is not None else time.perf_counter_ns()
    out: List[Event] = []
    for pid in sorted(lanes):
        for name, st in sorted(lanes[pid].items()):
            out.append(Event(
                name=COUNTER_PREFIX + name,
                path=(path_root,) + tuple(name.split(".")),
                category=COUNTER_CATEGORY,
                t_start=t,
                t_end=t,
                pid=pid,
                tid=0,
                attrs=st.to_attrs(),
            ))
    return out


def merge_lane_stats(dst: Dict[int, Dict[str, CounterStat]],
                     src: Dict[int, Dict[str, CounterStat]]) -> int:
    """Merge per-pid lane deltas ``src`` into cumulative ``dst`` in
    place (``dst`` takes ownership of stats it adopts). Returns the
    number of logical deltas merged (the sum of stat counts), the unit
    drain accounting speaks."""
    nd = 0
    for pid, per in src.items():
        d = dst.get(pid)
        if d is None:
            d = dst[pid] = {}
        for name, st in per.items():
            nd += st.count
            cur = d.get(name)
            if cur is None:
                d[name] = st
            else:
                cur.merge(st)
    return nd


def reduce_lanes(parts: Iterable[Dict[int, Dict[str, CounterStat]]]
                 ) -> Dict[int, Dict[str, CounterStat]]:
    """Reduce per-pid lane stat maps from independent shards into one map
    (the lane-merge step of :mod:`repro.corpus` sharded replay). Shards
    own disjoint pid sets under rank partitioning, so this is a plain
    union there; overlapping pids merge stat-by-stat. The result adopts
    (takes ownership of) the stats it absorbs."""
    out: Dict[int, Dict[str, CounterStat]] = {}
    for part in parts:
        merge_lane_stats(out, part)
    return out


def counter_stats(events: Iterable[Event]) -> Dict[str, CounterStat]:
    """Inverse of :meth:`CounterRegistry.snapshot_events`: collect counter
    Events (merging multiple snapshots of the same name) back into stats."""
    out: Dict[str, CounterStat] = {}
    for ev in events:
        if ev.category != COUNTER_CATEGORY or not ev.attrs:
            continue
        st = CounterStat.from_attrs(ev.attrs)
        if st.name in out:
            out[st.name].merge(st)
        else:
            out[st.name] = st
    return out


_GLOBAL: Optional[CounterRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def global_registry() -> CounterRegistry:
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = CounterRegistry()
    return _GLOBAL


def reset_global_registry(pid: int = 0) -> CounterRegistry:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = CounterRegistry(pid=pid)
    return _GLOBAL
