"""JSONL trace writer/reader (the persistence layer of ``repro_torch.trace``).

The writer is the ``emit(dict)`` sink the instrumented layers speak
(:class:`repro_torch.match.MatchEngine`, :class:`repro_torch.match.Fabric`,
:class:`repro_torch.comm.progress.ProgressEngine`): header first, ``.gz``
transparently compressed like :mod:`repro_torch.core.timeline`.

Emission is buffered and, at schema v3 (the default), *compacted*:
consecutive same-kind ``post``/``arr`` records accumulate in a chunk
maker and are written as one columnar ``chk`` line per run (delta
encoding, run-length on constant columns — see
:mod:`repro_torch.trace.schema`), so long runs cost ~a tenth of the per-op
bytes and one serialization per chunk instead of per record. Everything
else (and schema v2, which keeps the pre-compaction per-op encoding
byte-identical) goes through the buffered per-op path: records accumulate
in a per-writer list and are serialized in batches — one lock
acquisition, one ``"\\n".join`` of the batch, one file write. ``flush``
forces the chunk maker + buffer to disk; ``close`` flushes and is idempotent.

Reading is streaming: :class:`TraceReader` (also via :func:`iter_trace`)
validates the header eagerly, then yields records one line at a time,
expanding v3 chunks lazily — replaying a long trace never materializes
the full record list. :func:`read_trace` is the eager convenience over
it. Reader errors are typed: truncated or corrupt lines and unsupported
versions raise :class:`repro_torch.trace.schema.TraceFormatError` carrying the
path and 1-based line number. ``strict=False`` turns a reader lenient:
corrupt payload lines (truncated JSON, non-object lines, invalid
records, undecodable chunks) are *skipped* instead of raised, tallied
by category in ``reader.skipped``, and summarized in one
:class:`TraceCorruptionWarning` when the stream ends — the header stays
strict either way (a trace without a valid header is not a trace).

A copy of ``repro.trace.io``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import gzip
import json
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

from ..core.counters import CounterRegistry
from .schema import (REC_ARRIVE, REC_CHUNK, REC_PE_CHUNK, REC_POST,
                     REC_PROGRESS, SCHEMA_VERSION, WRITABLE_VERSIONS,
                     TraceFormatError, TraceSchemaError, decode_chunk,
                     decode_pe_chunk, encode_flags, encode_ints,
                     encode_outcomes, make_header, validate_header,
                     validate_record)

# record types that carry live wall-clock timing in schema v2+
_TIMED = ("post", "arr", "pe")

# records buffered between batch serializations (a batch is ~100 bytes
# per record, so the default keeps ~25 KiB in flight)
BUFFER_RECORDS = 256

# rows per v3 chunk: caps the memory a chunk maker holds and keeps chunk
# lines comfortably sized (~2-6 KiB) for line-oriented tooling
CHUNK_RECORDS = 512

# chunkable key sets per op kind: a record must match exactly (modulo
# the optional t_wall stamp) or it is written bare — external producers
# with extra/missing keys stay valid v3 without touching the chunk path
_POST_KEYS = frozenset(("t", "rank", "src", "tag", "comm", "seq", "hit"))
_ARR_KEYS = frozenset(("t", "rank", "src", "tag", "comm", "nb", "seq",
                       "match"))
_CHUNK_KEYS = {
    REC_POST: (_POST_KEYS, frozenset(_POST_KEYS | {"t_wall"})),
    REC_ARRIVE: (_ARR_KEYS, frozenset(_ARR_KEYS | {"t_wall"})),
}

# chunkable key sets for progress-lane ("pe") records, by event kind
_SUBMIT_KEYS = frozenset(("t", "ev", "ts", "wait"))
_PROC_KEYS = frozenset(("t", "ev", "ts", "dur"))
_PE_KEYS = {
    "submit": (_SUBMIT_KEYS, frozenset(_SUBMIT_KEYS | {"t_wall"})),
    "proc": (_PROC_KEYS, frozenset(_PROC_KEYS | {"t_wall"})),
}

# one shared encoder: json.dumps(..., separators=...) builds a fresh
# JSONEncoder per call, which is pure overhead at trace volume
_encode = json.JSONEncoder(separators=(",", ":")).encode


class TraceCorruptionWarning(UserWarning):
    """A lenient (``strict=False``) reader skipped corrupt lines; the
    message carries the per-category tally."""


def _open(path: str, write: bool, append: bool = False):
    if path.endswith(".gz"):
        # appending opens a new gzip member; readers decode the
        # concatenated members transparently
        return gzip.open(path, ("at" if append else "wt") if write
                         else "rt")
    return open(path, ("a" if append else "w") if write else "r")


class TraceWriter:
    """Append-only trace sink with a versioned header.

    Usable as a context manager; ``close`` is idempotent. ``n_records``
    counts logical records emitted including the header (chunked and
    buffered records included — everything is on disk after
    ``flush``/``close``).

    With ``wall_clock=True`` (the default) every engine-op / progress
    record is stamped with ``t_wall``, nanoseconds since the writer
    opened (schema v2+), so replays can report measured time dilation.
    The stamp is written into the caller's dict — ``emit`` takes
    ownership of the record, which every in-tree producer satisfies by
    emitting a fresh dict per op. ``wall_clock=False`` is deterministic
    mode: no ``t_wall`` stamps and counter snapshots exclude
    measured-time (``*_ns``) statistics, so the same op stream produces
    a byte-identical trace file — the property the workload scenario
    suite's determinism tests pin down.

    ``schema`` picks the encoding: 3 (the default) compacts post/arrive
    runs into columnar chunks (and progress-lane runs into ``pec``
    chunks); 2 writes the per-op records of the pre-compaction format
    byte-identically (the committed golden traces stay frozen at v2).
    ``buffer_records`` bounds the emission buffer (1 = write-through;
    chunks count as one buffered record).

    ``append=True`` re-opens an **existing** trace and continues it:
    the header is validated, the stream is scanned to re-seed the
    per-rank derived-seq counters from the tail (so later chunks keep
    reconstructing correctly), ``n_records`` resumes from the existing
    count, and new ``t_wall`` stamps continue monotonically after the
    largest recorded one. ``mode``/``meta`` are ignored (the existing
    header stands) and ``wall_clock`` is inferred from the recorded
    stream — a deterministic trace stays byte-deterministic across
    sessions, a wall-clock one keeps stamping. ``schema`` defaults to
    the file's version; an
    explicit *lower* writable version is allowed (bare v2 records are
    legal inside a v3 file), a higher one is rejected.
    """

    def __init__(self, path: str, mode: str = "binned",
                 meta: Optional[Dict] = None, wall_clock: bool = True,
                 buffer_records: int = BUFFER_RECORDS,
                 schema: Optional[int] = None, append: bool = False):
        self.path = str(path)
        self.wall_clock = wall_clock
        self._lock = threading.Lock()
        self._buf: List[Dict] = []
        self._cap = max(int(buffer_records), 1)
        self._chunk: List[Dict] = []     # pending chunkable records
        self._cflags: List[int] = []     # op: 1 = post row, 0 = arr row
        #                                  pe: 1 = submit,   0 = proc
        self._ctimed = False             # pending chunk carries t_wall
        self._ckind = "op"               # pending chunk kind: op | pe
        self._seqs: Dict[int, int] = {}  # per-rank next expected seq
        if append:
            try:
                (hdr, seqs, n_records, max_tw,
                 saw_tw) = self._scan_existing()
            except FileNotFoundError:
                raise TraceFormatError(
                    "cannot append: no existing trace at this path "
                    "(open without append=True to start one)",
                    path=self.path) from None
            # adopt the file's clock discipline: a deterministic trace
            # (no t_wall anywhere) must stay byte-deterministic across
            # append sessions; an empty trace keeps the caller's choice
            if n_records > 1:
                self.wall_clock = saw_tw
            file_schema = hdr.get("schema")
            if file_schema not in WRITABLE_VERSIONS:
                raise TraceSchemaError(
                    f"cannot append to a schema v{file_schema} trace "
                    f"(appendable: {WRITABLE_VERSIONS})")
            self.schema = (file_schema if schema is None
                           else int(schema))
            if self.schema not in WRITABLE_VERSIONS:
                raise TraceSchemaError(
                    f"cannot write schema v{self.schema} (writable: "
                    f"{WRITABLE_VERSIONS})")
            if self.schema > file_schema:
                raise TraceSchemaError(
                    f"cannot append v{self.schema} records to a "
                    f"v{file_schema} trace (bare lower-version records "
                    f"are legal in a newer file, not the reverse)")
            self._seqs = seqs
            self.n_records = n_records
            self._f = _open(self.path, write=True, append=True)
            # continue the live clock where the recorded one stopped
            self._t0 = time.perf_counter_ns() - max_tw
            return
        self.schema = SCHEMA_VERSION if schema is None else int(schema)
        if self.schema not in WRITABLE_VERSIONS:
            raise TraceSchemaError(
                f"cannot write schema v{self.schema} (writable: "
                f"{WRITABLE_VERSIONS})")
        self._f = _open(self.path, write=True)
        self.n_records = 0
        self._t0 = time.perf_counter_ns()
        self.emit(make_header(mode, meta, schema=self.schema))

    def _scan_existing(self):
        """Stream-validate the trace being appended to: returns
        ``(header, per-rank next seqs, logical record count including
        the header, max t_wall seen)``. Chunks are expanded so the
        count matches what ``emit`` would have accumulated."""
        n = 1                            # the header line
        max_tw = 0
        saw_tw = False
        with TraceReader(self.path, expand=True) as r:
            hdr = r.header
            for rec in r:
                n += 1
                tw = rec.get("t_wall")
                if tw is not None:
                    saw_tw = True
                    if type(tw) is int and tw > max_tw:
                        max_tw = tw
            seqs = dict(r._seqs)
        return hdr, seqs, n, max_tw, saw_tw

    def _flush_chunk_locked(self) -> None:
        recs = self._chunk
        if not recs:
            return
        flags = self._cflags
        self._chunk = []
        self._cflags = []
        if len(recs) == 1:
            # a bare record is smaller than a 1-row chunk
            self._buf.append(recs[0])
            return
        if self._ckind == "pe":
            self._flush_pe_chunk(recs, flags)
            return
        out: Dict = {"t": REC_CHUNK, "n": len(recs),
                     "p": encode_flags(flags)}
        for key, col in (("r", "rank"), ("s", "src"), ("g", "tag"),
                         ("c", "comm")):
            values = [r[col] for r in recs]
            if any(type(v) is not int for v in values):
                # non-int payload (an external producer): the delta
                # codec only round-trips ints — write the run bare
                self._buf.extend(recs)
                return
            enc = encode_ints(values)
            if key != "c" or enc != 0:   # comm omitted when all-zero
                out[key] = enc
        arrs = [r for r, p in zip(recs, flags) if not p]
        posts = [r for r, p in zip(recs, flags) if p]
        nbs = [r["nb"] for r in arrs]
        hits = [r["hit"] for r in posts]
        matches = [r["match"] for r in arrs]
        tws = [r["t_wall"] for r in recs] if self._ctimed else []
        if (any(type(v) is not int for v in nbs + tws)
                or any(v is not None and type(v) is not int
                       for v in hits + matches)):
            self._buf.extend(recs)
            return
        if nbs:
            benc = encode_ints(nbs)
            if benc != 0:                # nbytes omitted when all-zero
                out["b"] = benc
        henc = encode_outcomes(hits) if hits else None
        if henc is not None:
            out["h"] = henc
        menc = encode_outcomes(matches) if matches else None
        if menc is not None:
            out["m"] = menc
        if tws:
            out["w"] = encode_ints(tws)
        self._buf.append(out)

    def _flush_pe_chunk(self, recs: List[Dict],
                        flags: List[int]) -> None:
        """Columnar-encode a run of chunkable ``pe`` records (``flags``:
        1 = submit row, 0 = proc row) as one ``pec`` line."""
        tss = [r["ts"] for r in recs]
        waits = [r["wait"] for r, e in zip(recs, flags) if e]
        durs = [r["dur"] for r, e in zip(recs, flags) if not e]
        tws = [r["t_wall"] for r in recs] if self._ctimed else []
        if any(type(v) is not int for v in tss + waits + durs + tws):
            # non-int payload: the delta codec only round-trips ints
            self._buf.extend(recs)
            return
        out: Dict = {"t": REC_PE_CHUNK, "n": len(recs),
                     "e": encode_flags(flags), "s": encode_ints(tss)}
        if waits:
            uenc = encode_ints(waits)
            if uenc != 0:                # waits omitted when all-zero
                out["u"] = uenc
        if durs:
            denc = encode_ints(durs)
            if denc != 0:
                out["d"] = denc
        if tws:
            out["w"] = encode_ints(tws)
        self._buf.append(out)

    def _flush_locked(self) -> None:
        self._flush_chunk_locked()
        buf = self._buf
        if buf:
            self._f.write("\n".join(map(_encode, buf)) + "\n")
            self._buf = []

    def emit(self, rec: Dict) -> None:
        with self._lock:
            if self._f is None:
                raise ValueError(f"trace {self.path} is closed")
            kind = rec.get("t")
            if (self.wall_clock and kind in _TIMED
                    and "t_wall" not in rec):
                rec["t_wall"] = time.perf_counter_ns() - self._t0
            self.n_records += 1
            is_post = kind == REC_POST
            if self.schema >= 3 and (is_post or kind == REC_ARRIVE):
                keys = _CHUNK_KEYS[kind]
                rk = rec.keys()
                timed = rk == keys[1]
                seqs = self._seqs
                rank = rec.get("rank")
                seq = rec.get("seq")
                if ((timed or rk == keys[0]) and type(rank) is int
                        and type(seq) is int
                        and seq == seqs.get(rank, 0)):
                    # chunkable: seq is derivable (dense per-rank
                    # numbering), so it is dropped from the encoding
                    if ((timed != self._ctimed
                            or self._ckind != "op") and self._chunk):
                        self._flush_chunk_locked()
                    self._ctimed = timed
                    self._ckind = "op"
                    seqs[rank] = seq + 1
                    self._chunk.append(rec)
                    self._cflags.append(1 if is_post else 0)
                    if len(self._chunk) >= CHUNK_RECORDS:
                        self._flush_chunk_locked()
                        if len(self._buf) >= self._cap:
                            self._flush_locked()
                    return
                # bare op record: re-seed the rank's seq counter so
                # later chunk rows keep reconstructing correctly
                if type(rank) is int and type(seq) is int:
                    seqs[rank] = seq + 1
            elif self.schema >= 3 and kind == REC_PROGRESS:
                keys = _PE_KEYS.get(rec.get("ev"))
                if keys is not None:
                    rk = rec.keys()
                    timed = rk == keys[1]
                    if timed or rk == keys[0]:
                        if ((timed != self._ctimed
                                or self._ckind != "pe")
                                and self._chunk):
                            self._flush_chunk_locked()
                        self._ctimed = timed
                        self._ckind = "pe"
                        self._chunk.append(rec)
                        self._cflags.append(
                            1 if rec["ev"] == "submit" else 0)
                        if len(self._chunk) >= CHUNK_RECORDS:
                            self._flush_chunk_locked()
                            if len(self._buf) >= self._cap:
                                self._flush_locked()
                        return
            self._flush_chunk_locked()
            self._buf.append(rec)
            if len(self._buf) >= self._cap:
                self._flush_locked()

    def flush(self) -> None:
        """Serialize and write everything buffered so far, the pending
        chunk included (no-op when closed); readers tailing the file see
        all emitted records."""
        with self._lock:
            if self._f is not None:
                self._flush_locked()
                self._f.flush()

    def snapshot(self, registry: Optional[CounterRegistry],
                 lanes=None) -> None:
        """Write the registry's per-lane counter statistics as a ``snap``
        record (drains, so the snapshot reflects everything recorded so
        far; lane pids key the stats). In deterministic mode the
        wall-clock-measured ``*_ns`` statistics are dropped — they are
        the only nondeterministic content of a snapshot. When a live
        telemetry bridge was draining the registry concurrently, pass
        its cumulative ``lanes`` instead (registry may be None then):
        the registry's own remainder would be a partial view."""
        if lanes is None:
            lanes = registry.drain_lanes()
        stats = {str(pid): {name: st.to_attrs()
                            for name, st in sorted(per.items())
                            if self.wall_clock or not name.endswith("_ns")}
                 for pid, per in sorted(lanes.items())}
        self.emit({"t": "snap", "stats": stats})

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._flush_locked()
                self._f.close()
                self._f = None

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TraceReader:
    """Streaming trace reader: the header is read and validated eagerly
    (available as ``.header``); iterating yields validated records one
    at a time with v3 chunks expanded lazily, so consumers never hold
    the full record list. ``expand=False`` yields raw records (chunks
    intact) for columnar consumers like the batched replayer.

    Usable as a context manager; iteration closes the file when the
    stream ends. Malformed input raises
    :class:`~repro_torch.trace.schema.TraceFormatError` with the offending
    line number — unless ``strict=False``, which skips corrupt payload
    lines (counting them by category in ``skipped``: ``"json"`` for
    unparseable/non-object lines, ``"record"`` for invalid records,
    ``"chunk"`` for undecodable chunk columns) and warns once with the
    tally when the stream ends. The header is validated strictly
    regardless."""

    def __init__(self, path: str, expand: bool = True,
                 strict: bool = True):
        self.path = str(path)
        self.expand = expand
        self.strict = strict
        self.skipped: Dict[str, int] = {}
        self._lineno = 0
        self._seqs: Dict[int, int] = {}  # per-rank next derived seq
        self._f = _open(self.path, write=False)
        try:
            self.header: Dict = self._read_header()
        except BaseException:
            self.close()
            raise

    def _fail(self, message: str) -> TraceFormatError:
        return TraceFormatError(message, path=self.path, line=self._lineno)

    def _parse(self, line: str) -> Dict:
        try:
            rec = json.loads(line)
        except ValueError as e:
            raise self._fail(f"corrupt trace line: {e}") from None
        if not isinstance(rec, dict):
            raise self._fail("trace line is not a JSON object")
        return rec

    def _read_header(self) -> Dict:
        for line in self._f:
            self._lineno += 1
            line = line.strip()
            if not line:
                continue
            rec = self._parse(line)
            try:
                return validate_header(rec)
            except TraceFormatError:
                raise
            except TraceSchemaError as e:
                raise self._fail(str(e)) from None
        raise self._fail(f"empty trace file (no header): {self.path}")

    def _skip(self, category: str) -> None:
        self.skipped[category] = self.skipped.get(category, 0) + 1

    def __iter__(self) -> Iterator[Dict]:
        f = self._f
        if f is None:
            raise ValueError(f"trace reader for {self.path} is closed")
        expand = self.expand
        strict = self.strict
        v3 = self.header.get("schema", 0) >= 3
        try:
            for line in f:
                self._lineno += 1
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = self._parse(line)
                except TraceFormatError:
                    if strict:
                        raise
                    self._skip("json")
                    continue
                try:
                    validate_record(rec)
                except TraceFormatError:
                    if strict:
                        raise
                    self._skip("record")
                    continue
                except TraceSchemaError as e:
                    if strict:
                        raise self._fail(str(e)) from None
                    self._skip("record")
                    continue
                if v3:
                    # chunk expansion + derived-seq bookkeeping only
                    # exist at v3; pre-chunk files skip both
                    kind = rec.get("t")
                    if (not strict and not expand
                            and (kind == REC_CHUNK
                                 or kind == REC_PE_CHUNK)):
                        # raw lenient stream (the batched replayer):
                        # trial-decode against scratch state so a
                        # corrupt chunk is skipped here rather than
                        # exploding inside a columnar consumer
                        try:
                            if kind == REC_CHUNK:
                                for _ in decode_chunk(rec,
                                                      dict(self._seqs)):
                                    pass
                            else:
                                for _ in decode_pe_chunk(rec):
                                    pass
                        except (TraceFormatError, TraceSchemaError,
                                ValueError, TypeError, IndexError,
                                KeyError):
                            self._skip("chunk")
                            continue
                        yield rec
                        continue
                    if expand and (kind == REC_CHUNK
                                   or kind == REC_PE_CHUNK):
                        if strict:
                            try:
                                if kind == REC_CHUNK:
                                    yield from decode_chunk(
                                        rec, self._seqs)
                                else:
                                    yield from decode_pe_chunk(rec)
                            except TraceFormatError:
                                raise
                            except TraceSchemaError as e:
                                raise self._fail(str(e)) from None
                            continue
                        # lenient: decode eagerly against a scratch
                        # seq map so a wrong-arity chunk is skipped
                        # whole, never half-expanded
                        seqs = dict(self._seqs)
                        try:
                            if kind == REC_CHUNK:
                                rows = list(decode_chunk(rec, seqs))
                            else:
                                rows = list(decode_pe_chunk(rec))
                        except (TraceFormatError, TraceSchemaError,
                                ValueError, TypeError, IndexError,
                                KeyError):
                            self._skip("chunk")
                            continue
                        self._seqs = seqs
                        yield from rows
                        continue
                    if kind == REC_POST or kind == REC_ARRIVE:
                        # bare op: re-seed the rank's derived-seq
                        # counter (mirrors the writer's fallback)
                        rank, seq = rec.get("rank"), rec.get("seq")
                        if type(rank) is int and type(seq) is int:
                            self._seqs[rank] = seq + 1
                yield rec
            if self.skipped:
                warnings.warn(TraceCorruptionWarning(
                    f"{self.path}: skipped "
                    + ", ".join(f"{n} {cat} line(s)" for cat, n
                                in sorted(self.skipped.items()))),
                    stacklevel=2)
        finally:
            self.close()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "TraceReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_trace(path: str, expand: bool = True,
               strict: bool = True) -> TraceReader:
    """Streaming open: ``with iter_trace(p) as r: r.header; for rec in
    r: ...`` — decodes chunks lazily, one record in memory at a time.
    ``strict=False`` skips corrupt payload lines instead of raising
    (tallied in ``reader.skipped``)."""
    return TraceReader(path, expand=expand, strict=strict)


def read_trace(path: str) -> Tuple[Dict, List[Dict]]:
    """Eagerly load and validate a trace: returns ``(header, records)``
    with chunks expanded. Raises :class:`repro_torch.trace.schema
    .TraceFormatError` (a :class:`~repro_torch.trace.schema.TraceSchemaError`)
    on a version or shape mismatch — the schema gate
    ``scripts/verify.sh`` exercises."""
    with TraceReader(path) as r:
        return r.header, list(r)


def convert_trace(src: str, dst: str, schema: Optional[int] = None,
                  strict: bool = True,
                  skipped: Optional[Dict[str, int]] = None
                  ) -> Tuple[int, int]:
    """Re-encode a trace at another schema version (v2 <-> v3) without
    touching its content: records stream through unchanged — ``t_wall``
    stamps, phase markers, snapshots and meta are preserved — only the
    post/arrive encoding changes. Returns ``(n_records, n_ops)``.
    Converting v2 -> v3 -> v2 is byte-identical; replay statistics are
    equal in every direction (``scripts/trace_convert.py`` is the
    CLI). ``strict=False`` salvages a damaged source: corrupt lines
    are dropped from the converted output and tallied into the
    caller's ``skipped`` dict (the CLI's ``--lenient``)."""
    n_ops = 0
    with TraceReader(src, strict=strict) as r:
        hdr = r.header
        with TraceWriter(dst, mode=hdr.get("mode", "binned"),
                         meta=hdr.get("meta") or None, wall_clock=False,
                         schema=schema) as w:
            for rec in r:
                if rec["t"] in (REC_POST, REC_ARRIVE):
                    n_ops += 1
                w.emit(rec)
            if skipped is not None:
                skipped.update(r.skipped)
            return w.n_records, n_ops
