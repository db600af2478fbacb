"""Recorder: hook the comm layer and the matching fabric, persist a trace.

Two entry points, both context managers yielding the traced
:class:`repro_torch.match.Fabric`:

  * :func:`record_fabric` — trace a fabric driven directly (benchmarks,
    offline workloads; no comm layer involved).
  * :func:`record_collectives` — additionally install the fabric on the
    comm layer (:func:`repro_torch.comm.collectives.configure_matching`), so
    every ``psum`` / ``all_gather`` / ``ppermute`` a shard_map program
    dispatches — including the ring schedules and halo faces that route
    through them — is decomposed, matched *and recorded*.

On exit both write a final counter ``snap`` record (the record-time
ground truth replays are checked against) and close the file. The
progress engine is traced by passing the same writer to
``ProgressEngine(trace=writer)`` — its submit/process lane events land in
the same trace and replay under either queue discipline.

A copy of ``repro.trace.recorder``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

from ..core.counters import CounterRegistry
from ..match import Fabric, canonical_mode
from .io import TraceWriter


@contextlib.contextmanager
def record_fabric(path: str, mode: str = "binned",
                  registry: Optional[CounterRegistry] = None,
                  meta: Optional[Dict] = None, wall_clock: bool = True,
                  buffer_records: Optional[int] = None,
                  schema: Optional[int] = None,
                  **fabric_kwargs) -> Iterator[Fabric]:
    """Yield a fabric whose every engine op and collective phase is
    appended to the JSONL trace at ``path``. Emission is buffered
    (``buffer_records``, default :data:`repro_torch.trace.io.BUFFER_RECORDS`);
    everything is flushed by the final snapshot + close on exit — call
    ``fabric.trace.flush()`` mid-run if another process tails the file.
    ``wall_clock=False`` records in deterministic (byte-reproducible)
    mode; ``schema`` picks the trace encoding (3 = compact chunks, the
    default; 2 = the per-op pre-compaction format)."""
    reg = registry if registry is not None else CounterRegistry()
    writer_kwargs = {} if buffer_records is None else {
        "buffer_records": buffer_records}
    with TraceWriter(path, mode=canonical_mode(mode), meta=meta,
                     wall_clock=wall_clock, schema=schema,
                     **writer_kwargs) as writer:
        fabric = Fabric(mode=mode, registry=reg, trace=writer,
                        **fabric_kwargs)
        try:
            yield fabric
        finally:
            writer.snapshot(reg)


@contextlib.contextmanager
def record_collectives(path: str, mode: str = "binned",
                       registry: Optional[CounterRegistry] = None,
                       meta: Optional[Dict] = None, wall_clock: bool = True,
                       buffer_records: Optional[int] = None,
                       schema: Optional[int] = None,
                       **fabric_kwargs) -> Iterator[Fabric]:
    """Like :func:`record_fabric`, but also routes the live comm layer
    through the traced fabric for the duration of the block (restoring
    whatever fabric was configured before)."""
    from ..comm import collectives
    with record_fabric(path, mode=mode, registry=registry, meta=meta,
                       wall_clock=wall_clock, buffer_records=buffer_records,
                       schema=schema, **fabric_kwargs) as fabric:
        prev = collectives.matching_fabric()
        collectives.configure_matching(fabric)
        try:
            yield fabric
        finally:
            collectives.configure_matching(prev)
