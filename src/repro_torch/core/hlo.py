"""The recorded step: the port's counterpart of a compiled module's text
(port of ``repro.core.hlo``).

The JAX package parses the HLO text of a compiled step for its
collectives. The port runs eagerly and has no compiled module: a
:class:`Recorder` (a ``TorchDispatchMode``) records every op a rank runs
on its local tensors, with its operand and result shapes and dtypes, its
FLOPs and bytes, and every collective with its process group, in the
order the rank issues them. The list it returns, a :class:`Recording`, is
what ``compiled.as_text()`` is to the reference (:meth:`Recording.as_text`
prints it one op a line in HLO's type notation).

The recorder runs on real tensors (:func:`repro_torch.core.cost.count_cost`
records a step as it runs) and on fake ones: the dry run
(:mod:`repro_torch.launch.dryrun`) runs the step under ``FakeTensorMode``
on a ``fake`` process group of 256 or 512 ranks, where nothing is
allocated and nothing is sent. Either way:

  * it returns ``NotImplemented`` when a ``DTensor`` is among an op's
    types, so DTensor desugars the op first into the local op on each
    rank's shard and the ``_c10d_functional`` collectives of its
    redistributions, which the recorder then sees (``CommDebugMode``
    works the same way). Counted FLOPs and bytes are one rank's;
  * DTensor's sharding propagation runs the op once more at its global
    shape, in the same fake mode, the first time it meets a signature:
    those ops are not the rank's work and are not recorded;
  * an op that is not in ``torch.utils.flop_counter``'s registry is
    first offered its decomposition, as ``FlopCounterMode`` does, so the
    two count the same ops the same way;
  * the hand-written kernels are ``ctypes`` calls (or, in a dry run, the
    wrappers' fake branch) that no dispatch mode sees: each wrapper adds
    its work through :func:`repro_torch.core.cost.add_kernel`, which lands
    here as one ``kernel`` op.

A collective issued through ``_c10d_functional`` is the reference's
``-start`` and its ``wait_tensor`` its ``-done``; one issued through
``torch.distributed``'s in-place ops (``c10d.allreduce_`` and the like, as
:mod:`repro_torch.sharding.collectives` does) starts and ends at once. The
group size is the size of the collective's process group (a mesh
dimension). Wire bytes use :func:`repro_torch.core.cost.wire_bytes`, the
reference's ring formulas.

Left out, with no input here: ``logical_lines`` and ``symbol_table``
(there is no text to join or resolve: every op carries its own shapes)
and ``while_trip_counts`` (eager PyTorch unrolls its layers, so every
layer's ops are recorded and no loop is multiplied).
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from . import cost

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4, "f64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1, "f8e4m3b11fnuz": 1,
    "c64": 8, "c128": 16,
}
# torch dtypes by the HLO type names of DTYPE_BYTES
DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
    torch.float64: "f64", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.complex64: "c64",
    torch.complex128: "c128",
}

# collective ops by qualified name -> the HLO opcode the reference counts
COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-broadcast",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.broadcast_": "collective-broadcast",
}
# in-place c10d ops whose first argument is the output (a tensor or a list)
# and whose second is the input
_OUT_FIRST = {"c10d.allgather_", "c10d._allgather_base_",
              "c10d.allgather_into_tensor_coalesced_", "c10d.reduce_scatter_",
              "c10d._reduce_scatter_base_",
              "c10d.reduce_scatter_tensor_coalesced_", "c10d.alltoall_base_",
              "c10d.alltoall_"}
_WAIT = "_c10d_functional.wait_tensor"
# allocations that write nothing
_NO_BYTES = {"aten.empty", "aten.empty_strided", "aten.empty_like",
             "aten.new_empty", "aten.new_empty_strided"}
# the frames of DTensor's sharding propagation, which runs an op at its
# global shape to learn its output's metadata
_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                "_propagate_tensor_meta")


_REGISTERED = {str(k) for k in flop_registry}


def counts_flops(name: str) -> bool:
    """Whether ops named ``name`` (``aten.mm``) have a registered FLOP
    formula."""
    return name in _REGISTERED


def dtype_name(dtype: torch.dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def shape_bytes(dtype: str, shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 0)


def _types(tensors) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(dtype_name(t.dtype), tuple(t.shape)) for t in tensors]


def _nbytes(tensors) -> int:
    return sum(t.nbytes for t in tensors)


@dataclasses.dataclass
class CollectiveOp:
    name: str
    opcode: str                 # the HLO opcode (COLLECTIVE_OPS' values)
    is_async: bool              # issued through _c10d_functional
    operand_bytes: int          # sum of operand sizes (the spec's metric)
    result_bytes: int
    group_size: int             # the process group's size (1 if unknown)
    num_groups: int
    line: str

    @property
    def wire_bytes(self) -> int:
        """Modeled bytes crossing links per participating device, with the
        ring-algorithm costs of :func:`repro_torch.core.cost.wire_bytes`:

          all-reduce:        2*B*(g-1)/g     (reduce-scatter + all-gather)
          all-gather:        B_out*(g-1)/g
          reduce-scatter:    B_in*(g-1)/g
          all-to-all:        B*(g-1)/g
          collective-permute/broadcast: B
        """
        return cost.wire_bytes(self.opcode, self.operand_bytes,
                               self.group_size)


@dataclasses.dataclass
class RecordedOp:
    """One op a rank ran: ``kind`` is ``op`` (a local aten op), ``kernel``
    (a hand-written kernel's launch, with its work from its shapes),
    ``collective`` (issued) or ``done`` (its ``wait_tensor``); ``start``
    of a ``done`` is the index of its collective, and ``done`` of a
    collective the index of its wait (its own for a synchronous one)."""
    index: int
    name: str
    kind: str
    operands: List[Tuple[str, Tuple[int, ...]]]
    results: List[Tuple[str, Tuple[int, ...]]]
    flops: float = 0.0
    bytes: int = 0
    collective: Optional[CollectiveOp] = None
    start: Optional[int] = None
    done: Optional[int] = None

    @property
    def line(self) -> str:
        def types(ts):
            return ", ".join(f"{d}[{','.join(map(str, s))}]" for d, s in ts)
        res = types(self.results)
        if len(self.results) != 1:
            res = f"({res})"
        extra = ""
        if self.collective is not None:
            c = self.collective
            extra = (f", opcode={c.opcode}, group_size={c.group_size}"
                     + ("" if c.is_async else ", sync"))
        if self.kind == "done":
            extra = f", start=%{self.start}"
        return (f"%{self.index} = {res} {self.name}({types(self.operands)})"
                f"{extra}")


def _resolve_group(args) -> Tuple[int, int]:
    """(group size, number of groups) of a collective's process group: a
    group name (``_c10d_functional``) or a ProcessGroup object (c10d)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    for a in args:
        pg = None
        if isinstance(a, str):
            try:
                pg = dist.distributed_c10d._resolve_process_group(a)
            except Exception:       # not a group name
                continue
        elif isinstance(a, dist.ProcessGroup):
            pg = a
        if pg is not None:
            size = pg.size()
            return size, max(1, world // max(1, size))
    return 1, 1


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


class Recording:
    """A recorded step: its ops in issue order (:class:`RecordedOp`), and,
    when memory was tracked, the live bytes of its tensors' storages."""

    def __init__(self):
        self.ops: List[RecordedOp] = []
        self.open: Dict[int, int] = {}      # id(output) -> collective index
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self._watched: Dict[int, Any] = {}   # id -> storage, held alive
        self._read: set = set()

    # -- memory -------------------------------------------------------------
    def hold(self, tensors) -> None:
        """Count the storages of ``tensors`` as live (once each) until they
        are freed."""
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t.is_meta:
                continue
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def watch(self, tensors) -> None:
        """Note which of ``tensors`` (a step's arguments) the recorded ops
        read (:meth:`read_args`)."""
        for t in tensors:
            st = t.untyped_storage()
            self._watched[id(st)] = st

    def note_reads(self, tensors) -> None:
        """Mark the watched storages behind ``tensors`` as read."""
        if not self._watched:
            return
        for t in tensors:
            if isinstance(t, torch.Tensor) and not t.is_meta:
                sid = id(t.untyped_storage())
                if sid in self._watched:
                    self._read.add(sid)

    def read_args(self, tensors) -> List[torch.Tensor]:
        """Those of the watched ``tensors`` that a recorded op, or a
        kernel's fake launch, read: the reference's compiled step keeps
        only the arguments it uses (``jax.jit``'s ``keep_unused=False``),
        and its argument bytes count only those."""
        return [t for t in tensors if id(t.untyped_storage()) in self._read]

    def storage_bytes(self, tensors) -> int:
        """Bytes of the distinct storages behind ``tensors``."""
        seen = {}           # id -> storage, held so that no id is reused
        for t in tensors:
            st = t.untyped_storage()
            seen.setdefault(id(st), st)
        return sum(st.nbytes() for st in seen.values())

    # -- text ---------------------------------------------------------------
    def as_text(self) -> str:
        return "\n".join(op.line for op in self.ops)

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self):
        return iter(self.ops)


class Recorder(TorchDispatchMode):
    """Records the ops a rank runs, as the module docstring says. Enter it
    inside ``FakeTensorMode`` for a dry run; ``track_memory`` also follows
    the live bytes of every storage the step creates (the dry run's memory
    analysis)."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.recording = Recording()
        self.track_memory = track_memory
        self.paused = 0         # inside a kernel's plain version (stand_in)
        self.by_shape: Dict[str, int] = defaultdict(int)

    def add_kernel(self, name: str, flops: float, nbytes: float,
                   shape: Optional[str] = None) -> None:
        rec = self.recording
        rec.ops.append(RecordedOp(len(rec.ops), f"kernel.{name}", "kernel",
                                  [], [], flops=float(flops),
                                  bytes=int(nbytes)))
        if shape is not None:
            self.by_shape[shape] += 1

    def note_reads(self, tensors) -> None:
        """A kernel's fake launch read ``tensors``
        (:meth:`Recording.note_reads`)."""
        if not self.paused:
            self.recording.note_reads(tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self.paused or _in_propagation():
            return func(*args, **kwargs)
        if (func not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        rec = self.recording
        packet = str(func.overloadpacket)
        if packet == "prim.device":
            return
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        rec.note_reads(ins)
        if self.track_memory:
            rec.hold(outs)
        index = len(rec.ops)
        if packet == _WAIT:
            start = rec.open.pop(id(ins[0]), None) if ins else None
            if start is not None:
                rec.ops[start].done = index
            rec.ops.append(RecordedOp(index, packet, "done", _types(ins),
                                      _types(outs), start=start))
            return
        opcode = COLLECTIVE_OPS.get(packet)
        if opcode is not None:
            if packet in _OUT_FIRST:
                results, operands = _split_lists(args)
            else:
                operands = ins
                results = outs if packet.startswith("_c10d") else ins
            size, groups = _resolve_group(list(args) + list(kwargs.values()))
            is_async = packet.startswith("_c10d_functional")
            op = RecordedOp(index, packet, "collective", _types(operands),
                            _types(results),
                            bytes=_nbytes(operands) + _nbytes(results))
            op.collective = CollectiveOp(
                name=f"%{index}", opcode=opcode, is_async=is_async,
                operand_bytes=_nbytes(operands), result_bytes=_nbytes(results),
                group_size=size, num_groups=groups, line="")
            rec.ops.append(op)
            op.collective.line = op.line
            if is_async:
                for t in outs:
                    rec.open[id(t)] = index
            else:
                op.done = index
            return
        fn = flop_registry.get(func.overloadpacket)
        flops = fn(*args, **kwargs, out_val=out) if fn is not None else 0
        nbytes = 0
        if not func.is_view and packet not in _NO_BYTES:
            nbytes = _nbytes(ins) + _nbytes(outs)
        rec.ops.append(RecordedOp(index, packet, "op", _types(ins),
                                  _types(outs), flops=float(flops),
                                  bytes=nbytes))


def _split_lists(args) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(outputs, inputs) of a c10d op whose first two arguments are the
    output and the input, each a tensor or a list of them."""
    outs = [t for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor)]
    ins = [t for t in tree_leaves(args[1]) if isinstance(t, torch.Tensor)]
    return outs, ins


# ---------------------------------------------------------------------------
# the reference's readers, over a recording
# ---------------------------------------------------------------------------

def parse_collectives(recorded: Recording) -> List[CollectiveOp]:
    """Every collective of the recording (issued ones: a ``done`` adds
    none)."""
    return [op.collective for op in recorded.ops
            if op.collective is not None]


@dataclasses.dataclass
class CollectiveStats:
    total_operand_bytes: int
    total_wire_bytes: int
    count: int
    by_opcode: Dict[str, Dict[str, int]]
    async_count: int

    def summary(self) -> str:
        lines = [
            f"collectives: {self.count} ops, "
            f"{self.total_operand_bytes / 1e9:.3f} GB operands, "
            f"{self.total_wire_bytes / 1e9:.3f} GB modeled wire traffic, "
            f"{self.async_count} async"
        ]
        for op, d in sorted(self.by_opcode.items()):
            lines.append(
                f"  {op:20s} x{d['count']:<4d} {d['operand_bytes'] / 1e9:9.3f} GB op, "
                f"{d['wire_bytes'] / 1e9:9.3f} GB wire"
            )
        return "\n".join(lines)


def collective_stats(recorded: Recording) -> CollectiveStats:
    ops = parse_collectives(recorded)
    by: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0, "wire_bytes": 0}
    )
    for op in ops:
        d = by[op.opcode]
        d["count"] += 1
        d["operand_bytes"] += op.operand_bytes
        d["wire_bytes"] += op.wire_bytes
    return CollectiveStats(
        total_operand_bytes=sum(o.operand_bytes for o in ops),
        total_wire_bytes=sum(o.wire_bytes for o in ops),
        count=len(ops),
        by_opcode=dict(by),
        async_count=sum(1 for o in ops if o.is_async),
    )


def op_histogram(recorded: Recording) -> Dict[str, int]:
    """Op histogram — useful for spotting remat-duplicated compute and
    layout-change churn."""
    hist: Dict[str, int] = defaultdict(int)
    for op in recorded.ops:
        hist[op.name] += 1
    return dict(hist)


def record(fn, *args: Any, **kwargs: Any) -> Tuple[Any, Recording]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`Recorder` (open to
    the kernel wrappers' work); return (its result, the recording)."""
    rec = Recorder()
    with cost.tally(rec), rec:
        result = fn(*args, **kwargs)
    return result, rec.recording
