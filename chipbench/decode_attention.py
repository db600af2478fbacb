"""The decode-attention kernels' share of their roofline over the decode
steps of a traced serving run, read from the Kineto trace.

The port's decode attention is one kernel an attention layer a step,
whose name holds ``decode_attn`` (its splits combine inside the launch,
in a thread block cluster). A decode step
replays a captured CUDA graph: its kernels carry the correlation of the
one ``cudaGraphLaunch`` under ``serve/decode_step``, so they are found by
name among the kernels launched there, and each is given to the
``chipbench/call`` span open at its launch. The reader returns None
without a trace or a call, and where any call's count is not its
attention layers times its steps: a program without the kernel (one
that attends in plain torch) reads nothing.
"""
from __future__ import annotations

from typing import Dict, Optional

from .frozen import work
from .frozen.device_timeline import _Trace
from .frozen.peaks import PEAK_BYTES
from .program_spans import CALL, _window_spans
from .readers import _calls, _n_layers

SYMBOL = "decode_attn"
STEP = "serve/decode_step"
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_bytes(d: Dict, B: int, ctx: int) -> int:
    """Bytes one decode-attention call must move: the ``ctx`` filled
    slots of the K and V caches read once (a windowed layer's ring holds
    at most its window: ``work.seen``), q read and out written once."""
    K, D, H = d["n_kv_heads"], d["head_dim"], d["n_heads"]
    return (2 * B * ctx * K * D + 2 * B * H * D) * ITEMSIZE[d["dtype"]]


def decode_attn_roofline(rec: Dict) -> Optional[float]:
    """The least time of every decode step's attention calls (the filled
    cache at ``PEAK_BYTES``) over the kernel's time in the trace, in %."""
    calls = _calls(rec)
    if not calls:
        return None
    d = rec["dims"]
    n_attn = _n_layers(d, "attn")
    tr = _Trace(rec["trace"])
    spans = sorted((ts, end) for ts, end, n in _window_spans(tr) if n == CALL)
    if not n_attn or len(spans) != len(calls):
        return None
    counts = [0] * len(calls)
    us = 0.0
    for g in tr.gpu:
        if SYMBOL not in g.name or STEP not in tr.chain(g.launch):
            continue
        inside = [i for i, (a, b) in enumerate(spans)
                  if a <= g.launch[0] <= b]
        if len(inside) != 1:
            return None
        counts[inside[0]] += 1
        us += g.end - g.ts
    if any(n != n_attn * c["gen"] for n, c in zip(counts, calls)):
        return None
    least = sum(n_w * least_bytes(d, c["n"], work.seen(c["P"] + j + 1, w))
                for c in calls for j in range(c["gen"])
                for w, n_w in work.attn_windows(d).items()) / PEAK_BYTES
    return 100.0 * least / (us / 1e6)
