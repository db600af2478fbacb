"""Versioned record schema for ``repro_torch.trace`` JSONL traces.

A trace is one JSON object per line. The first line is the header; every
following line is a record tagged by its ``"t"`` field:

  ``hdr``    header: ``format``, ``schema`` (version), the engine ``mode``
             the run was recorded under, free-form ``meta``.
  ``post``   MPI_Irecv analog on one rank: envelope (``src``/``tag``/
             ``comm``), the per-engine sequence number ``seq``, and the
             match outcome ``hit`` (seq of the unexpected message the
             receive pulled from the UMQ, or null).
  ``arr``    network delivery on one rank: envelope plus payload size
             ``nb``, ``seq``, and outcome ``match`` (seq of the posted
             receive the message matched, or null -> parked on the UMQ).
  ``phase``  phase marker: ``op`` (collective kind or ``"phase"`` for
             explicit markers), human ``label``, optional attrs (``n``,
             ``nb``, ``tag``). The replayer snapshots counters at every
             marker — this is the alignment unit the differ works in.
  ``pe``     progress-engine lane event: ``ev`` = ``submit`` (``ts``,
             lock ``wait``) or ``proc`` (``ts``, processing ``dur``),
             nanosecond timestamps.
  ``snap``   counter snapshot: per-pid ``stats`` in the
             :meth:`repro_torch.core.counters.CounterStat.to_attrs` encoding.
  ``chk``    **schema v3** chunk: a run of consecutive ``post``/``arr``
             records (kinds freely mixed), columnar-encoded (see
             below). One chunk line replaces up to
             :data:`~repro_torch.trace.io.CHUNK_RECORDS` per-op lines.
  ``pec``    **schema v3** progress-lane chunk: a run of consecutive
             ``pe`` records (``submit``/``proc`` freely mixed),
             columnar-encoded with the same codecs as ``chk``.

Chunk layout (v3). A chunk carries ``n`` (row count) plus one encoded
column per logical field, single-letter keys::

  {"t":"chk","n":N,"p":F,"r":C,"s":C,"g":C,"c":C?,"b":C?,"h":O?,
   "m":O?,"w":C?}

``p`` (is-post flags, 1 = ``post`` row, 0 = ``arr`` row) is a bare int
when uniform, else a run-length pair list ``[v0,n0,v1,n1,...]`` — an
exchange phase's post/arrive/late-post stages become three pairs.
Integer columns ``C`` — ``r`` rank, ``s`` src, ``g`` tag, ``c`` comm,
``b`` nbytes, ``w`` t_wall — are either a bare int (run-length-constant
column: the value shared by every row) or a **delta list**
``[v0, v1-v0, v2-v1, ...]`` (phase-local envelopes and monotone
``t_wall`` streams make the deltas small, which is where the byte
shrink comes from). Outcome columns ``O`` (``h`` = post ``hit``, ``m``
= arr ``match``) are nullable and never delta-encoded: the raw value
list, or omitted when every value is null (the common miss/park case).
``c`` defaults to 0 when absent. ``b``/``h`` apply only to their kind's
rows and have that sub-population's length (``b``/``m`` over arr rows,
``h`` over post rows); ``w`` is present only when the compacted records
carried timing.

Progress-lane chunk layout (v3)::

  {"t":"pec","n":N,"e":F,"s":C,"u":C?,"d":C?,"w":C?}

``e`` (is-submit flags, 1 = ``submit`` row, 0 = ``proc`` row) uses the
same run-length form as ``p``. ``s`` is the ``ts`` column (delta-encoded
— submit timestamps are monotone, so deltas are small). ``u`` (submit
``wait``) spans the submit rows only and ``d`` (processing ``dur``) the
proc rows only; each is omitted when its sub-population is empty or
all-zero (waits usually are). ``w`` is ``t_wall``, present only when
the compacted records carried timing. ``pe`` records have no ``seq``,
so expansion needs no cross-chunk state — decoding reproduces the
per-op records exactly, key order included.

Per-op ``seq`` numbers are **derived, not stored**: every engine
numbers its ops densely from 0 in emission order, so the decoder
reconstructs ``seq`` with one per-rank counter threaded across the
whole stream (bare ``post``/``arr`` records re-seed their rank's
counter from their explicit ``seq``). The writer verifies the invariant
per record and falls back to bare records whenever a producer's seqs
are not dense, so expanding a chunk reproduces the per-op records
exactly — key order included — and converting a v2 trace to v3 and
back is byte-identical.

Version history:

  * **v1** — the per-op record types above, no per-op timing.
  * **v2** — ``post``/``arr``/``pe`` records may carry ``t_wall``:
    live wall-clock nanoseconds since the writer opened, stamped by
    :class:`repro_torch.trace.io.TraceWriter` (``wall_clock=True``, the
    default). Optional — a writer in deterministic mode omits it, and
    v1 traces never have it — so readers treat it as advisory timing
    (the replayer surfaces it as measured per-phase wall time /
    dilation).
  * **v3** — compact chunked encoding: the post/arrive streams are
    delta-encoded into columnar ``chk`` records and the progress-lane
    stream into ``pec`` records. Bare ``post``/``arr``/``pe`` records
    remain legal in a v3 file (the writer falls back to them for
    single-record runs and nonconforming producer dicts); readers
    expand chunks transparently, so every consumer of v1/v2 records
    keeps working unchanged.

Schema changes MUST bump :data:`SCHEMA_VERSION`; readers accept every
version in :data:`SUPPORTED_VERSIONS` and reject anything newer
(``scripts/verify.sh`` gates on this round-tripping). Writers speak
:data:`WRITABLE_VERSIONS` — ``scripts/trace_convert.py`` re-encodes a
trace in either direction.

A copy of ``repro.trace.schema``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

from itertools import accumulate
from typing import Dict, List, Optional

SCHEMA_VERSION = 3
SUPPORTED_VERSIONS = (1, 2, 3)
# versions a TraceWriter can emit: 2 = per-op records (the pre-compaction
# encoding, byte-identical to the per-op writer), 3 = chunked
WRITABLE_VERSIONS = (2, 3)
TRACE_FORMAT = "repro.trace"

REC_HEADER = "hdr"
REC_POST = "post"
REC_ARRIVE = "arr"
REC_PHASE = "phase"
REC_PROGRESS = "pe"
REC_SNAPSHOT = "snap"
REC_CHUNK = "chk"
REC_PE_CHUNK = "pec"
# fault-injection marker (repro.faults): one record per (exchange,
# active fault spec), annotation-only — replay derives nothing from it
# (the faulted op stream itself is what post/arr records carry), so
# every replayer/converter passes it through untouched and the
# v2 <-> v3 byte-identity rule is preserved (flt records are never
# chunked)
REC_FAULT = "flt"

# required fields per record type (beyond "t")
_REQUIRED = {
    REC_POST: ("rank", "src", "tag", "seq"),
    REC_ARRIVE: ("rank", "src", "tag", "seq"),
    REC_PHASE: ("op", "label"),
    REC_PROGRESS: ("ev", "ts"),
    REC_SNAPSHOT: ("stats",),
    REC_CHUNK: ("n", "p", "r", "s", "g"),
    REC_PE_CHUNK: ("n", "e", "s"),
    REC_FAULT: ("kind",),
}


class TraceSchemaError(ValueError):
    """A trace file does not conform to the schema this reader speaks."""


class TraceFormatError(TraceSchemaError):
    """A trace file is malformed at a specific line: truncated or corrupt
    JSON, an unsupported version, or an invalid record/chunk shape. The
    reader raises this (with ``path`` and 1-based ``line``) instead of
    letting ``json.JSONDecodeError`` / bare ``ValueError`` leak
    mid-stream; it subclasses :class:`TraceSchemaError` so existing
    handlers keep working."""

    def __init__(self, message: str, path: Optional[str] = None,
                 line: Optional[int] = None):
        where = f"{path or '<trace>'}:{line if line is not None else '?'}"
        super().__init__(f"{where}: {message}")
        self.path = path
        self.line = line


def make_header(mode: str, meta: Optional[Dict] = None,
                schema: int = SCHEMA_VERSION) -> Dict:
    return {"t": REC_HEADER, "format": TRACE_FORMAT,
            "schema": schema, "mode": mode, "meta": meta or {}}


def validate_header(rec: Dict) -> Dict:
    if rec.get("t") != REC_HEADER:
        raise TraceSchemaError(
            f"first record must be a {REC_HEADER!r} header, got "
            f"{rec.get('t')!r}")
    if rec.get("format") != TRACE_FORMAT:
        raise TraceSchemaError(
            f"not a {TRACE_FORMAT} trace (format={rec.get('format')!r})")
    if rec.get("schema") not in SUPPORTED_VERSIONS:
        raise TraceSchemaError(
            f"unsupported schema version {rec.get('schema')!r} "
            f"(this reader speaks versions {SUPPORTED_VERSIONS})")
    return rec


_REQUIRED_SETS = {kind: frozenset(fields)
                  for kind, fields in _REQUIRED.items()}


def validate_record(rec: Dict) -> Dict:
    kind = rec.get("t")
    req = _REQUIRED_SETS.get(kind)
    if req is None:
        raise TraceSchemaError(f"unknown record type {kind!r}")
    # one C-level subset check per record on the happy path; the field
    # list is only reconstructed to name what's missing
    if not req <= rec.keys():
        missing = [f for f in _REQUIRED[kind] if f not in rec]
        raise TraceSchemaError(
            f"{kind!r} record missing required field(s) {missing}")
    return rec


# -- v3 column codec -------------------------------------------------------

def encode_ints(values: List[int]):
    """Encode one integer column: a bare int when the column is constant
    (run-length on constant columns), else the delta list
    ``[v0, v1-v0, ...]``. Inverse of :func:`decode_ints`."""
    first = values[0]
    out = [first]
    prev = first
    constant = True
    for v in values[1:]:
        out.append(v - prev)
        constant = constant and v == prev
        prev = v
    return first if constant else out


def decode_ints(enc, n: int, name: str = "column") -> List[int]:
    """Expand one encoded integer column back to its ``n`` row values."""
    if type(enc) is list:
        if len(enc) != n:
            raise TraceSchemaError(
                f"chunk {name} column has {len(enc)} entries for "
                f"{n} rows")
        return list(accumulate(enc))
    if type(enc) is not int:
        raise TraceSchemaError(
            f"chunk {name} column must be an int or a delta list, "
            f"got {type(enc).__name__}")
    return [enc] * n


def encode_outcomes(values: List[Optional[int]]):
    """Encode one nullable outcome column (``hit``/``match``): ``None``
    when every row is null, else the raw value list (outcomes are
    recorded seqs with null gaps — deltas would not round-trip)."""
    for v in values:
        if v is not None:
            return list(values)
    return None


def decode_outcomes(enc, n: int, name: str = "outcome"
                    ) -> List[Optional[int]]:
    if enc is None:
        return [None] * n
    if type(enc) is not list or len(enc) != n:
        raise TraceSchemaError(
            f"chunk {name} column must be null or a {n}-entry list")
    return enc


def encode_flags(values: List[int]):
    """Encode the is-post column: a bare int when uniform, else
    run-length pairs ``[v0, n0, v1, n1, ...]`` (an op stream is runs of
    posts and runs of arrivals — pairs beat per-row deltas)."""
    first = values[0]
    out: List[int] = []
    run_v, run_n = first, 0
    uniform = True
    for v in values:
        if v == run_v:
            run_n += 1
        else:
            out += (run_v, run_n)
            run_v, run_n = v, 1
            uniform = False
    if uniform:
        return first
    out += (run_v, run_n)
    return out


def decode_flags(enc, n: int) -> List[int]:
    """Expand the is-post column back to one 0/1 flag per row."""
    if type(enc) is int:
        if enc not in (0, 1):
            raise TraceSchemaError(f"chunk p flag must be 0 or 1, "
                                   f"got {enc!r}")
        return [enc] * n
    if type(enc) is not list or len(enc) % 2:
        raise TraceSchemaError(
            "chunk p column must be an int or [value, run, ...] pairs")
    out: List[int] = []
    it = iter(enc)
    for v, run in zip(it, it):
        if v not in (0, 1) or type(run) is not int or run < 1:
            raise TraceSchemaError(
                f"invalid chunk p run ({v!r}, {run!r})")
        out += [v] * run
    if len(out) != n:
        raise TraceSchemaError(
            f"chunk p runs cover {len(out)} rows, chunk has {n}")
    return out


def decode_chunk(rec: Dict, seqs: Optional[Dict[int, int]] = None
                 ) -> List[Dict]:
    """Expand a validated ``chk`` record into its per-op records (exact
    v2 key order, ``t_wall`` last when present). ``seqs`` is the
    per-rank next-seq counter threaded across the stream by the caller
    (:class:`repro_torch.trace.io.TraceReader`); it is updated in place. With
    ``seqs=None`` a fresh numbering starts at this chunk — only correct
    for a chunk inspected in isolation."""
    n = rec["n"]
    if type(n) is not int or n < 1:
        raise TraceSchemaError(f"chunk row count must be a positive int, "
                               f"got {n!r}")
    if seqs is None:
        seqs = {}
    try:
        flags = decode_flags(rec["p"], n)
        ranks = decode_ints(rec["r"], n, "r")
        srcs = decode_ints(rec["s"], n, "s")
        tags = decode_ints(rec["g"], n, "g")
    except KeyError as e:
        raise TraceSchemaError(f"chunk missing column {e.args[0]!r}") \
            from None
    comms = decode_ints(rec.get("c", 0), n, "c")
    n_post = sum(flags)
    n_arr = n - n_post
    nbs = iter(decode_ints(rec.get("b", 0), n_arr, "b") if n_arr
               else ())
    hits = iter(decode_outcomes(rec.get("h"), n_post, "h"))
    matches = iter(decode_outcomes(rec.get("m"), n_arr, "m"))
    tws = (iter(decode_ints(rec["w"], n, "w")) if "w" in rec
           else None)
    out: List[Dict] = []
    for p, r, s, g, c in zip(flags, ranks, srcs, tags, comms):
        q = seqs.get(r, 0)
        seqs[r] = q + 1
        if p:
            op = {"t": REC_POST, "rank": r, "src": s, "tag": g,
                  "comm": c, "seq": q, "hit": next(hits)}
        else:
            op = {"t": REC_ARRIVE, "rank": r, "src": s, "tag": g,
                  "comm": c, "nb": next(nbs), "seq": q,
                  "match": next(matches)}
        if tws is not None:
            op["t_wall"] = next(tws)
        out.append(op)
    return out


def decode_pe_chunk(rec: Dict) -> List[Dict]:
    """Expand a validated ``pec`` record into its per-event ``pe``
    records (exact v2 key order: ``t``, ``ev``, ``ts``, then ``wait`` or
    ``dur``, ``t_wall`` last when present). Progress records carry no
    seq, so no cross-chunk state is threaded."""
    n = rec["n"]
    if type(n) is not int or n < 1:
        raise TraceSchemaError(f"pe chunk row count must be a positive "
                               f"int, got {n!r}")
    flags = decode_flags(rec["e"], n)
    tss = decode_ints(rec["s"], n, "s")
    n_sub = sum(flags)
    n_proc = n - n_sub
    waits = iter(decode_ints(rec.get("u", 0), n_sub, "u") if n_sub
                 else ())
    durs = iter(decode_ints(rec.get("d", 0), n_proc, "d") if n_proc
                else ())
    tws = (iter(decode_ints(rec["w"], n, "w")) if "w" in rec
           else None)
    out: List[Dict] = []
    for e, ts in zip(flags, tss):
        if e:
            op = {"t": REC_PROGRESS, "ev": "submit", "ts": ts,
                  "wait": next(waits)}
        else:
            op = {"t": REC_PROGRESS, "ev": "proc", "ts": ts,
                  "dur": next(durs)}
        if tws is not None:
            op["t_wall"] = next(tws)
        out.append(op)
    return out
