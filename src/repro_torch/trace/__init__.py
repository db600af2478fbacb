# Communication trace capture + deterministic what-if replay: record the
# matching fabric's post/arrive stream (and the progress engine's lane
# events) to a versioned JSONL trace once — compact columnar chunks at
# schema v3 — then re-drive it offline through any engine configuration
# (streaming + batched, or per-op with match-order verification) —
# counters, detectors and the trace differ all run on replayed data, no
# workload re-execution needed.
# A copy of ``repro.trace``: the port imports nothing of the JAX
# package. Keep the two in step.
from .diff import PhaseDelta, TraceDiff, diff
from .io import (TraceCorruptionWarning, TraceReader, TraceWriter,
                 convert_trace, iter_trace, read_trace)
from .legacy_replay import LegacyReplayer, legacy_replay
from .recorder import record_collectives, record_fabric
from .replay import (LOCK_REGION, PartitionScan, PhaseStats, Replayer,
                     ReplayResult, replay, replay_progress,
                     scan_partition)
from .schema import (SCHEMA_VERSION, SUPPORTED_VERSIONS, TRACE_FORMAT,
                     WRITABLE_VERSIONS, TraceFormatError,
                     TraceSchemaError, decode_chunk, decode_pe_chunk,
                     make_header, validate_header, validate_record)

__all__ = [
    "PhaseDelta", "TraceDiff", "diff",
    "TraceCorruptionWarning", "TraceReader", "TraceWriter",
    "convert_trace", "iter_trace", "read_trace",
    "LegacyReplayer", "legacy_replay",
    "record_collectives", "record_fabric",
    "LOCK_REGION", "PartitionScan", "PhaseStats", "Replayer",
    "ReplayResult", "replay", "replay_progress", "scan_partition",
    "SCHEMA_VERSION", "SUPPORTED_VERSIONS", "TRACE_FORMAT",
    "WRITABLE_VERSIONS", "TraceFormatError", "TraceSchemaError",
    "decode_chunk", "decode_pe_chunk", "make_header", "validate_header",
    "validate_record",
]
