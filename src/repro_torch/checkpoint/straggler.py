"""Straggler and failure detection, fed by the paper's own profiling
substrate: per-rank step timings are Events; the irregularity detector
from core.analyses flags ranks whose steps run long.

At scale this runs on the coordinator: ranks report step durations
(cheap scalars), the detector maintains a rolling window, and sustained
outliers trigger (a) hot-spare swap-in or (b) checkpoint-and-reshard via
elastic.py. Here the policy engine is fully implemented and unit-tested;
the transport is a callback.

A copy of ``repro.checkpoint.straggler``: the port imports nothing of the
JAX package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional

from ..core.analyses import Finding


@dataclasses.dataclass
class StragglerPolicy:
    window: int = 32               # steps of history per rank
    slow_factor: float = 1.5       # step_time > factor * fleet median
    sustained: int = 8             # consecutive slow steps before action
    dead_factor: float = 10.0      # missing/this-slow means presumed dead


class StragglerDetector:
    def __init__(self, policy: StragglerPolicy = StragglerPolicy(),
                 on_straggler: Optional[Callable[[int], None]] = None,
                 on_failure: Optional[Callable[[int], None]] = None):
        self.policy = policy
        self._hist: Dict[int, Deque[float]] = defaultdict(
            lambda: deque(maxlen=self.policy.window))
        self._slow_streak: Dict[int, int] = defaultdict(int)
        self.on_straggler = on_straggler
        self.on_failure = on_failure
        self.flagged: List[Finding] = []

    def record(self, rank: int, step: int, duration_s: float) -> None:
        self._hist[rank].append(duration_s)
        med = self.fleet_median()
        if med is None:
            return
        p = self.policy
        if duration_s > p.dead_factor * med:
            self.flagged.append(Finding(
                kind="failure", severity=duration_s,
                message=f"rank {rank} step {step}: {duration_s:.3f}s "
                        f">= {p.dead_factor}x fleet median {med:.3f}s"))
            if self.on_failure:
                self.on_failure(rank)
            return
        if duration_s > p.slow_factor * med:
            self._slow_streak[rank] += 1
            if self._slow_streak[rank] >= p.sustained:
                self.flagged.append(Finding(
                    kind="straggler", severity=duration_s - med,
                    message=f"rank {rank}: {self._slow_streak[rank]} "
                            f"consecutive steps > {p.slow_factor}x median"))
                if self.on_straggler:
                    self.on_straggler(rank)
                self._slow_streak[rank] = 0
        else:
            self._slow_streak[rank] = 0

    def fleet_median(self) -> Optional[float]:
        vals = [d for h in self._hist.values() for d in h]
        if len(vals) < 4:
            return None
        return statistics.median(vals)
