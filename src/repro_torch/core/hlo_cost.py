"""FLOPs, bytes and collective bytes of a recorded step (port of
``repro.core.hlo_cost``).

The reference walks the compiled module's call graph and multiplies each
``while`` body by its trip count, because XLA's cost analysis visits a
loop body once. A :class:`repro_torch.core.hlo.Recording` has no loops:
eager PyTorch runs every layer, so every op of every layer is recorded,
and :func:`module_cost` sums them (``trip_counts`` stays empty).

  * FLOPs of each local op come from ``torch.utils.flop_counter``'s
    registered formulas (products and convolutions; elementwise ops count
    none, as ``FlopCounterMode`` counts them); the hand-written kernels
    add their work from their shapes (``core.cost.add_kernel``): they are
    always costed at their boundary, as the reference's
    ``--fused-accounting`` charges its Pallas kernels' interiors no HBM
    bytes;
  * bytes are counted as ``core.cost.count_cost`` counts them: operands
    plus results of every op, with views and uninitialized allocations
    counting none, and a collective's operand and result (a ``wait_tensor``
    counts none). This is an **upper estimate** of HBM traffic: an operand
    read from L2, or a fused read, counts in full;
  * collectives are the recorded ones (:func:`repro_torch.core.hlo.parse_collectives`),
    with the reference's ring wire bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .hlo import Recording


@dataclasses.dataclass
class ModuleCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_operand_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_count: float = 0.0
    collectives_by_opcode: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    trip_counts: List[int] = dataclasses.field(default_factory=list)
    # (opcode, operand_bytes) -> {count, wire_bytes}: the size histogram
    # that localizes *which* collective dominates
    collective_sizes: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )

    def top_collectives(self, n: int = 10):
        items = sorted(self.collective_sizes.items(),
                       key=lambda kv: -kv[1]["wire_bytes"])
        return items[:n]


def module_cost(recorded: Recording) -> ModuleCost:
    """One rank's FLOPs, bytes and collectives over the recorded step."""
    cost = ModuleCost()
    for op in recorded.ops:
        cost.flops += op.flops
        cost.bytes_accessed += op.bytes
        cop = op.collective
        if cop is None:
            continue
        cost.collective_count += 1
        cost.collective_operand_bytes += cop.operand_bytes
        cost.collective_wire_bytes += cop.wire_bytes
        d = cost.collectives_by_opcode.setdefault(
            cop.opcode, {"count": 0.0, "operand_bytes": 0.0, "wire_bytes": 0.0}
        )
        d["count"] += 1
        d["operand_bytes"] += cop.operand_bytes
        d["wire_bytes"] += cop.wire_bytes
        skey = f"{cop.opcode}@{cop.operand_bytes}B/g{cop.group_size}"
        sz = cost.collective_sizes.setdefault(
            skey, {"count": 0.0, "wire_bytes": 0.0})
        sz["count"] += 1
        sz["wire_bytes"] += cop.wire_bytes
    return cost
