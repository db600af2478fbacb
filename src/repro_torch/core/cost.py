"""FLOPs and bytes of one step, counted over the ops it runs, and the
collectives it dispatches (the port's counterpart of the JAX package's
``hlo_cost.module_cost`` and ``hlo.collective_stats``).

The JAX package reads these from the compiled HLO of a step. The port runs
eagerly and has no compiled module, so :func:`count_cost` counts the step
as it runs:

  * FLOPs of the aten ops from ``torch.utils.flop_counter.FlopCounterMode``;
  * FLOPs and bytes of the hand-written CUDA kernels, which are ``ctypes``
    calls that no dispatch mode sees: each kernel wrapper adds its own,
    from its shapes, once per launch (:func:`add_kernel`, with the
    formulas of :func:`attention_work`, :func:`backward_work` and
    :func:`scan_work`, which ``chip_smoke.py`` also uses for its bounds);
  * bytes as every op's operand bytes plus result bytes: an **upper
    estimate** of HBM traffic (an operand read from L2, or a fused
    read, counts in full). The card has no HBM counter without ``ncu``.
    View ops and uninitialized allocations move no bytes and count none.

:func:`collective_stats` reads the collectives from the comm layer's
regions (category ``"collective"``, named ``op(axis)``, with ``bytes=``
one rank's block) with the ring-algorithm wire costs of the reference's
``CollectiveOp.wire_bytes``.

HLO-text parsing (``core/hlo.py``, ``core/hlo_cost.py``) has no input in
the port yet: it comes with a ``dryrun`` counterpart (ROADMAP Queue 1).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .events import Event

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# the hand-written kernels' work, from their shapes
# ---------------------------------------------------------------------------

def unmasked_pairs(T: int, S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs that the causal/window mask lets through."""
    pairs = 0
    for t in range(T):
        hi = min(t, S - 1) if causal else S - 1
        lo = max(0, t - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def attention_work(B: int, T: int, S: int, H: int, K: int, D: int,
                   causal: bool, window: Optional[int], itemsize: int
                   ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one forward call: 4·D useful FLOPs per unmasked
    (q, k) pair per head (s and p·v); q, k, v read once, out and the f32
    lse written once."""
    flops = 4 * D * B * H * unmasked_pairs(T, S, causal, window)
    nbytes = (2 * B * T * H * D + 2 * B * S * K * D) * itemsize + B * H * T * 4
    return flops, nbytes


def backward_work(B: int, T: int, S: int, H: int, K: int, D: int,
                  causal: bool, window: Optional[int], itemsize: int
                  ) -> Dict[str, Tuple[int, int]]:
    """(FLOPs, bytes) of each backward kernel: 6·D FLOPs per unmasked pair
    per head for dq (s, dp, ds·k) and 8·D for dk/dv (s, dp, pᵀ·do,
    dsᵀ·q); q, k, v, do, lse, delta read once, dq (or dk, dv) written
    once. Returns {"dq": (flops, bytes), "dkv": (flops, bytes)}."""
    pairs = B * H * unmasked_pairs(T, S, causal, window)
    reads = ((2 * B * T * H * D + 2 * B * S * K * D) * itemsize
             + 2 * B * H * T * 4)
    return {name: (per_pair * D * pairs, reads + written * itemsize)
            for name, per_pair, written in (("dq", 6, B * T * H * D),
                                            ("dkv", 8, 2 * B * S * K * D))}


def scan_work(B: int, T: int, dI: int, N: int, x_item: int, p_item: int
              ) -> Tuple[int, int, int]:
    """(f32 FLOPs, ex2 evaluations, bytes) of one selective-scan call: 6
    FLOPs per (b, t, d, n) (dt·A, dx·B, two FMAs) and 3 per (b, t, d)
    (dt·x, an FMA with D); one ex2 per (b, t, d, n); x, dt, B, C, A, D read
    once, y and the final state written once."""
    nbytes = (B * T * dI * (2 * x_item + p_item) + 2 * B * T * N * p_item
              + dI * N * 4 + dI * 4 + B * dI * N * 4)
    return B * T * dI * (6 * N + 3), B * T * dI * N, nbytes


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCost:
    """What :func:`count_cost` counted: ``flops`` (aten ops and kernels),
    ``bytes`` (an upper estimate, see the module docstring), the aten
    FLOPs by op, and each hand-written kernel's launches, FLOPs and
    bytes."""
    flops: float = 0.0
    bytes: float = 0.0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)


_ACTIVE: List[StepCost] = []         # the tallies count_cost has open


def counting() -> bool:
    """Whether a :func:`count_cost` block is open (kernel wrappers compute
    their work only then)."""
    return bool(_ACTIVE)


def add_kernel(name: str, flops: float, nbytes: float) -> None:
    """Add one launch of hand-written kernel ``name`` to every open tally."""
    for cost in _ACTIVE:
        k = cost.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        cost.flops += flops
        cost.bytes += nbytes


# allocations that write nothing
_NO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
             aten.new_empty_strided}


class _ByteCounter(TorchDispatchMode):
    """Adds each op's operand and result bytes to ``cost.bytes``."""

    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket not in _NO_BYTES:
            self.cost.bytes += sum(
                t.nbytes for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def count_cost() -> Iterator[StepCost]:
    """Count the FLOPs and bytes of the ops run inside the block (on every
    thread autograd uses) and of the hand-written kernels launched there.
    The tally is complete when the block exits."""
    cost = StepCost()
    flop_counter = FlopCounterMode(display=False)
    _ACTIVE.append(cost)
    try:
        with flop_counter, _ByteCounter(cost):
            yield cost
    finally:
        _ACTIVE.remove(cost)
        for op, n in flop_counter.get_flop_counts().get("Global", {}).items():
            cost.flops_by_op[str(op)] = cost.flops_by_op.get(str(op), 0) + n
        cost.flops += flop_counter.get_total_flops()


def step_cost(fn, *args: Any, **kwargs: Any) -> Tuple[Any, StepCost]:
    """Run ``fn(*args, **kwargs)`` once under :func:`count_cost`; return
    (its result, the tally)."""
    with count_cost() as cost:
        result = fn(*args, **kwargs)
    return result, cost


# ---------------------------------------------------------------------------
# collectives, from the comm layer's regions
# ---------------------------------------------------------------------------

# the comm layer's wrappers by the HLO opcode the reference counts them as
OPCODES = {"psum": "all-reduce", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
           "ppermute": "collective-permute"}
_REGION = re.compile(r"(\w+)\((\w+)\)")


def wire_bytes(opcode: str, operand_bytes: int, group: int) -> int:
    """Bytes crossing links per participating device under the ring
    algorithm (the reference's ``CollectiveOp.wire_bytes``; an all-gather's
    result is ``group`` operands)."""
    g = max(1, group)
    if opcode == "all-reduce":
        return int(2 * operand_bytes * (g - 1) / g)
    if opcode == "all-gather":
        return int(operand_bytes * g * (g - 1) / g)
    if opcode in ("reduce-scatter", "all-to-all"):
        return int(operand_bytes * (g - 1) / g)
    return operand_bytes


def collective_stats(events: Iterable[Event], axis_sizes: Dict[str, int]
                     ) -> Dict[str, Any]:
    """``count``, ``operand_bytes``, ``wire_bytes`` and ``by_opcode`` (the
    reference's ``hlo_stats`` keys) of the collective regions in
    ``events``; ``axis_sizes`` gives each mesh axis's group size."""
    by: Dict[str, Dict[str, int]] = {}
    for e in events:
        m = _REGION.fullmatch(e.name)
        if (e.category != "collective" or m is None
                or m.group(1) not in OPCODES or not e.attrs
                or "bytes" not in e.attrs):
            continue
        opcode = OPCODES[m.group(1)]
        nbytes = int(e.attrs["bytes"])
        d = by.setdefault(opcode, {"count": 0, "operand_bytes": 0,
                                   "wire_bytes": 0})
        d["count"] += 1
        d["operand_bytes"] += nbytes
        d["wire_bytes"] += wire_bytes(opcode, nbytes,
                                      axis_sizes.get(m.group(2), 1))
    return {"count": sum(d["count"] for d in by.values()),
            "operand_bytes": sum(d["operand_bytes"] for d in by.values()),
            "wire_bytes": sum(d["wire_bytes"] for d in by.values()),
            "by_opcode": by}
