"""FLOPs and bytes of one step, counted over the ops it runs, and the
collectives it dispatches (the port's counterpart of the JAX package's
``hlo_cost.module_cost`` and ``hlo.collective_stats``).

The JAX package reads these from the compiled HLO of a step. The port runs
eagerly and has no compiled module, so :func:`count_cost` counts the step
as it runs:

  * FLOPs of the aten ops from ``torch.utils.flop_counter``'s registered
    formulas, over the ops one rank runs (:class:`.hlo.Recorder`: under
    DTensor the local ops on the rank's shards, not the global ones);
  * FLOPs and bytes of the hand-written CUDA kernels, which are ``ctypes``
    calls that no dispatch mode sees: each kernel wrapper adds its own,
    from its shapes, once per launch, and once per call of its plain
    version on the CPU, whose own ops are not counted (:func:`add_kernel`,
    :func:`stand_in`, with the formulas of :func:`attention_work`,
    :func:`decode_attention_work`, :func:`backward_work`, :func:`scan_work`
    and :func:`scan_bwd_work`, which ``chip_smoke.py`` also uses for its
    bounds);
  * bytes as every op's operand bytes plus result bytes: an **upper
    estimate** of HBM traffic (an operand read from L2, or a fused
    read, counts in full). The card has no HBM counter without ``ncu``.
    View ops and uninitialized allocations move no bytes and count none.

:func:`collective_stats` reads the collectives from the comm layer's
regions (category ``"collective"``, named ``op(axis)``, with ``bytes=``
one rank's block) with the ring-algorithm wire costs of the reference's
``CollectiveOp.wire_bytes``.

The same recorder reads a dry run's step (:mod:`.hlo`, :mod:`.hlo_cost`,
:mod:`repro_torch.launch.dryrun`), the port's counterpart of the
reference's compiled-HLO parsing: a count on the card and a dry run's
prediction come from one counter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from .events import Event

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


def decode_attention_work(B: int, S: int, H: int, K: int, D: int,
                          itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one decode-attention call, one query position
    against S slots: 4·D FLOPs per (slot, head); the S slots of k and v
    and their int32 positions read once, q read and out written once."""
    flops = 4 * D * B * H * S
    nbytes = (2 * B * S * K * D + 2 * B * H * D) * itemsize + 4 * S
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


def scan_work(B: int, T: int, dI: int, N: int, x_item: int, p_item: int,
              chunks: int = 0) -> Tuple[int, int, int]:
    """(f32 FLOPs, ex2 evaluations, bytes) of one selective-scan call: 6
    FLOPs per (b, t, d, n) (dt·A, dx·B, two FMAs) and 3 per (b, t, d)
    (dt·x, an FMA with D); one ex2 per (b, t, d, n); x, dt, B, C, A, D read
    once, y and the final state written once, and ``chunks`` f32 states
    when a training forward saves them."""
    nbytes = (B * T * dI * (2 * x_item + p_item) + 2 * B * T * N * p_item
              + dI * N * 4 + dI * 4 + B * dI * N * 4 * (1 + chunks))
    return B * T * dI * (6 * N + 3), B * T * dI * N, nbytes


def scan_bwd_work(B: int, T: int, dI: int, N: int, x_item: int,
                  p_item: int, chunks: int) -> Tuple[int, int, int]:
    """(f32 FLOPs, ex2 evaluations, bytes) of one selective-scan backward
    call from ``chunks`` saved states a batch row. Per (b, t, d, n) 22
    FLOPs: h_{t-1} recomputed from the tile's saved state (dt·A, dx·B, an
    FMA: 4), g_t = dy·C + a·g_{t+1} (3), dx's and ddt's sums
    (g·B; a·h·A + x·B and g·(…): 8), dA (3), dB and dC (a product and a
    sum over d each: 4); per (b, t, d) 6 (dt·x, dt·Σ + D·dy, dy·x into
    dD). One ex2 per (b, t, d, n): the least the gradients need. x, dt, dy,
    B, C, A, D and the saved states read once; dx, ddt, dB, dC, dA and dD
    written once (the kernel's per-block partial sums are its own
    traffic and count none)."""
    nbytes = (B * T * dI * (3 * x_item + 2 * p_item) + 4 * B * T * N * p_item
              + 2 * (dI * N * 4 + dI * 4) + B * chunks * dI * N * 4)
    return B * T * dI * (22 * N + 6), B * T * dI * N, nbytes


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCost:
    """What :func:`count_cost` counted: ``flops`` (aten ops and kernels),
    ``bytes`` (an upper estimate, see the module docstring), the aten
    FLOPs by op, each hand-written kernel's launches, FLOPs and bytes,
    the kernel calls by shape (``fwd/128/causal``: the keys of
    ``flash_attention.launches_by_shape``), the collectives by opcode
    (``count``, ``operand_bytes``, ``wire_bytes``) and the recording the
    tally was read from (:class:`repro_torch.core.hlo.Recording`)."""
    flops: float = 0.0
    bytes: float = 0.0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    by_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    recording: Any = None


_ACTIVE: List[Any] = []      # the open recorders (hlo.Recorder)


def counting() -> bool:
    """Whether a :func:`count_cost` block (or a dry run's recording) is
    open: kernel wrappers compute their work only then."""
    return bool(_ACTIVE)


def add_kernel(name: str, flops: float, nbytes: float,
               shape: Optional[str] = None) -> None:
    """Add one launch of hand-written kernel ``name`` (its call ``shape``
    key, when given) to every open tally."""
    for rec in _ACTIVE:
        rec.add_kernel(name, flops, nbytes, shape)


def note_reads(*tensors) -> None:
    """A kernel's fake launch read ``tensors``: every open recording marks
    the step arguments among them as used."""
    for rec in _ACTIVE:
        rec.note_reads(tensors)


@contextlib.contextmanager
def tally(recorder) -> Iterator[None]:
    """Open ``recorder`` (an :class:`repro_torch.core.hlo.Recorder`) to the
    kernel wrappers' :func:`add_kernel` inside the block."""
    _ACTIVE.append(recorder)
    try:
        yield
    finally:
        _ACTIVE.remove(recorder)


@contextlib.contextmanager
def stand_in(work) -> Iterator[None]:
    """The block runs a kernel's plain version, which stands in for it on
    the CPU: every open tally skips the block's ops and adds ``work()``
    instead, a list of :func:`add_kernel` argument tuples (name, flops,
    bytes, shape), so a count on the CPU is the card's count."""
    active = list(_ACTIVE)
    for rec in active:
        rec.paused += 1
    try:
        yield
    finally:
        for rec in active:
            rec.paused -= 1
        if active:
            for args in work():
                for rec in active:
                    rec.add_kernel(*args)


@contextlib.contextmanager
def count_cost() -> Iterator[StepCost]:
    """Count the FLOPs and bytes of the ops run inside the block (on every
    thread autograd uses), one rank's under DTensor (the local ops and the
    collectives, :class:`repro_torch.core.hlo.Recorder`), and of the
    hand-written kernels launched there; on the CPU a kernel's plain
    version counts as the kernel it stands in for (:func:`stand_in`). The
    tally is complete when the block exits."""
    from . import hlo

    cost = StepCost()
    rec = hlo.Recorder()
    try:
        with tally(rec), rec:
            yield cost
    finally:
        cost.recording = rec.recording
        for op in rec.recording.ops:
            cost.flops += op.flops
            cost.bytes += op.bytes
            if op.kind == "kernel":
                k = cost.kernels.setdefault(op.name[len("kernel."):], {
                    "launches": 0, "flops": 0.0, "bytes": 0.0})
                k["launches"] += 1
                k["flops"] += op.flops
                k["bytes"] += op.bytes
            elif op.kind == "op" and hlo.counts_flops(op.name):
                cost.flops_by_op[op.name] = (cost.flops_by_op.get(op.name, 0)
                                             + op.flops)
        cost.by_shape = dict(rec.by_shape)
        cost.collectives = hlo.collective_stats(rec.recording).by_opcode


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
    if opcode in ("reduce-scatter", "all-to-all", "ragged-all-to-all"):
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
