# Live telemetry over the columnar counter substrate: a TelemetryBridge
# polls CounterRegistry instances on a daemon thread, streams per-pid
# delta frames (schema v1, trace-v3 encoding idioms) to subscribers —
# in-process ring, JSONL sink, HTTP/SSE endpoint — and runs the cheap
# detectors each poll so matching-engine defects surface mid-run, not in
# the post-mortem. Producers never block: the bridge is one more consumer
# on the registry's swap-out drain.
# A copy of ``repro.telemetry``: the port imports nothing of the JAX
# package. Keep the two in step.
from .bridge import DEFAULT_PERIOD_S, TelemetryBridge
from .schema import (FRAME_DELTA, FRAME_END, FRAME_FINDING, FRAME_HEADER,
                     TELEMETRY_FORMAT, TELEMETRY_SCHEMA,
                     TelemetryFrameError, decode_lanes, decode_stat,
                     encode_lanes, encode_stat, frame_lanes,
                     make_delta_frame, make_end_frame, make_finding_frame,
                     make_telemetry_header, validate_frame)
from .server import TelemetryServer
from .subscribers import (CallbackSubscriber, ClientQueue, FrameRing,
                          JsonlSink, read_jsonl)

__all__ = [
    "DEFAULT_PERIOD_S", "TelemetryBridge",
    "FRAME_DELTA", "FRAME_END", "FRAME_FINDING", "FRAME_HEADER",
    "TELEMETRY_FORMAT", "TELEMETRY_SCHEMA", "TelemetryFrameError",
    "decode_lanes", "decode_stat", "encode_lanes", "encode_stat",
    "frame_lanes", "make_delta_frame", "make_end_frame",
    "make_finding_frame", "make_telemetry_header", "validate_frame",
    "TelemetryServer",
    "CallbackSubscriber", "ClientQueue", "FrameRing", "JsonlSink",
    "read_jsonl",
]
