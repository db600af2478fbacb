"""Three-term roofline model of one step on the H100 (data-sheet constants).

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = HBM_bytes_per_device / HBM_bw
    collective term = wire_bytes_per_device / link_bw

All inputs are per-device quantities; the dominant term approximates the
step time lower bound; its fraction of the total is the roofline
fraction. In the port the FLOPs and bytes are counted over the ops of one
step (:mod:`.cost`), not read from a compiled module.

``match_s`` optionally feeds *measured* message-matching overhead (the
method-2 PRQ/UMQ search counters, via :func:`match_seconds`) into the
collective term: host-side matching rides the communication critical
path, so a defective engine shows up as a fatter collective bar on the
timeline — counters and the model meet in one place.

A copy of ``repro.core.roofline`` with the default ``HW`` of an NVIDIA
H100 SXM in place of the reference's TPU constants, and its link term
named ``link_bw``; every formula is the reference's. Keep the two in
step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .counters import CounterStat

# NVIDIA H100 SXM, one card, from NVIDIA's data sheet (not measured):
# dense bf16 tensor-core rate, HBM3 bandwidth, NVLink bandwidth in one
# direction, HBM capacity. The rates assume the 700 W power limit.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s
    "hbm_bw": 3.35e12,           # B/s
    "link_bw": 450e9,            # B/s, NVLink, one direction
    "hbm_gb": 80.0,
}


@dataclasses.dataclass
class Roofline:
    # raw per-device inputs
    flops: float
    hbm_bytes: float
    wire_bytes: float
    n_chips: int
    # model facts
    model_flops: Optional[float] = None      # 6*N*D (active params) global
    # measured matching-engine overhead (method-2 counters), seconds
    match_s: Optional[float] = None
    hw: Dict[str, float] = dataclasses.field(default_factory=lambda: dict(HW))

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw["peak_flops_bf16"]

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw["hbm_bw"]

    @property
    def t_match(self) -> float:
        """Measured PRQ/UMQ search time (0 when no counters were fed)."""
        return self.match_s or 0.0

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / self.hw["link_bw"] + self.t_match

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_overlapped(self) -> float:
        """Ideal step time if all three engines fully overlap."""
        return self.t_bound

    @property
    def t_serial(self) -> float:
        """Step time if nothing overlaps."""
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / HLO_FLOPs (global) — how much compiled compute is
        'useful'; catches remat/redundancy waste. > 1 would indicate the
        compiler found *fewer* flops than the model math (e.g. dropped MoE
        experts); < 1 indicates remat / padding / dispatch overhead."""
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / (self.flops * self.n_chips)

    @property
    def mfu_bound(self) -> Optional[float]:
        """Model-FLOPs utilization at the roofline bound (the score: how
        close the compiled step could get to peak if it hits the bound)."""
        if not self.model_flops:
            return None
        per_dev_useful = self.model_flops / self.n_chips
        return (per_dev_useful / self.hw["peak_flops_bf16"]) / self.t_bound

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_match": self.t_match,
            "t_collective": self.t_collective,
            "bound": self.bound,
            "t_bound": self.t_bound,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
        }

    def summary(self) -> str:
        coll = f"collective {self.t_collective * 1e3:9.3f} ms"
        if self.t_match:
            coll += f" (incl. match {self.t_match * 1e3:.3f} ms)"
        parts = [
            f"compute {self.t_compute * 1e3:9.3f} ms",
            f"memory {self.t_memory * 1e3:9.3f} ms",
            coll,
            f"bound={self.bound:10s}",
        ]
        uf = self.useful_flops_fraction
        if uf is not None:
            parts.append(f"useful={uf:.3f}")
        mfu = self.mfu_bound
        if mfu is not None:
            parts.append(f"mfu_bound={mfu:.3f}")
        return " | ".join(parts)


def match_seconds(stats: Dict[str, CounterStat]) -> float:
    """Measured matching-engine search time out of method-2 counter stats
    (from :meth:`CounterRegistry.drain`, :func:`counter_stats` over
    snapshot events, or a trace replay's ``totals()``)."""
    total_ns = 0.0
    for name in ("match.prq.search_ns", "match.umq.search_ns"):
        st = stats.get(name)
        if st is not None:
            total_ns += st.total
    return total_ns / 1e9
