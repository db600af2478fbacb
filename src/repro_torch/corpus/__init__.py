# Trace corpus + parallel sharded replay: partition a recorded v3 trace
# into independent per-rank (or warmup-prefixed per-phase) shards, fan
# them out across a spawn-safe process pool and reduce the counter lanes
# back into one ReplayResult stat-identical to serial replay — then
# scale out: a manifest-driven store of committed scenario traces and a
# runner that replays the whole corpus concurrently against the current
# engine, diffing every entry against its committed expectations
# (trace/diff.py, align="label") into a hard CI pass/fail.
# A copy of ``repro.corpus``: the port imports nothing of the JAX
# package. Keep the two in step.
from .codec import (DETERMINISTIC_COUNTERS, decode_phases, encode_phases,
                    encode_shard, finding_kinds, result_from_phases,
                    result_from_signature, signature, signature_phases)
from .parallel import (PARTITIONS, InlinePool, ReplayPool, default_jobs,
                       merge_shards, parallel_replay, plan_shards,
                       shard_worker, usable_cores)
from .runner import CorpusRunResult, EntryResult, run_corpus
from .store import (CORPUS_FORMAT, CORPUS_VERSION, ENGINE_MODES,
                    FAULT_CELLS, MANIFEST_NAME, CorpusEntry, CorpusStore,
                    file_sha256, refresh_expectations, seed_corpus)

__all__ = [
    "DETERMINISTIC_COUNTERS", "decode_phases", "encode_phases",
    "encode_shard", "finding_kinds", "result_from_phases",
    "result_from_signature", "signature", "signature_phases",
    "PARTITIONS", "InlinePool", "ReplayPool", "default_jobs",
    "merge_shards", "parallel_replay", "plan_shards", "shard_worker",
    "usable_cores",
    "CorpusRunResult", "EntryResult", "run_corpus",
    "CORPUS_FORMAT", "CORPUS_VERSION", "ENGINE_MODES", "FAULT_CELLS",
    "MANIFEST_NAME", "CorpusEntry", "CorpusStore", "file_sha256",
    "refresh_expectations", "seed_corpus",
]
