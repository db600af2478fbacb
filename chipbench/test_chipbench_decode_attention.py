"""The decode-attention roofline reader on a hand-made record and Kineto
trace: graph-replayed kernels found by name under ``serve/decode_step``,
given to the call open at their launch, and counted against the layers
and steps."""
from __future__ import annotations

import pytest

from chipbench import cells
from chipbench.decode_attention import decode_attn_roofline, least_bytes
from chipbench.frozen.peaks import PEAK_BYTES

SPLIT = "void (anonymous namespace)::decode_attn_split_kernel<128, 3>(Args)"


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace(gen=3, n_attn=2, calls=1, extra=()):
    """``calls`` call spans of ``gen`` decode steps each; each step one
    ``cudaGraphLaunch`` whose kernel of every attention layer (5 us)
    carries its correlation, beside a 20 us GEMM; a warm-up step's eager
    launch under ``serve/capture`` before them."""
    ev = [_ev("user_annotation", "device_timeline/window", 0, 10 ** 6)]
    corr, t = 1, 10
    for _ in range(calls):
        start = t
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t + 1, 1,
                      correlation=corr))
        ev.append(_ev("user_annotation", "serve/capture", t, 5))
        ev.append(_ev("kernel", SPLIT, t + 2, 4, tid=7, correlation=corr,
                      stream=7))
        corr, t = corr + 1, t + 10
        for _ in range(gen):
            ev.append(_ev("user_annotation", "serve/decode_step", t, 5))
            ev.append(_ev("cuda_runtime", "cudaGraphLaunch", t + 1, 1,
                          correlation=corr))
            k = t + 2
            for _ in range(n_attn):
                ev.append(_ev("kernel", SPLIT, k, 5, tid=7,
                              correlation=corr, stream=7))
                k += 5
            ev.append(_ev("kernel", "nvjet_gemm", k, 20, tid=7,
                          correlation=corr, stream=7))
            corr, t = corr + 1, k + 30
        ev.append(_ev("user_annotation", "chipbench/call", start, t - start))
        t += 100
    return {"traceEvents": ev + list(extra)}


def _record(trace, gen=3, calls=1):
    cfg = cells.load_json(cells.HERE / "configs" / "yi-6b.json")
    d = cells.dims(dict(cfg, num_hidden_layers=2))
    call = {"n": 2, "P": 64, "gen": gen, "t0_ns": 0, "t1_ns": 2_000_000,
            "prefill_start_ns": 500_000, "prefill_ms": 1.0,
            "decode_ms_mean": 0.25, "requests": [0, 1]}
    return {"kind": "serve", "dims": d, "mix": {},
            "calls": [dict(call) for _ in range(calls)], "trace": trace}


@pytest.mark.parametrize("calls", [1, 2])
def test_reads_the_replayed_kernels_against_the_filled_cache(calls):
    rec = _record(_trace(calls=calls), calls=calls)
    d = rec["dims"]
    least = calls * sum(2 * least_bytes(d, 2, 64 + j + 1)
                        for j in range(3)) / PEAK_BYTES
    # per call: 3 steps x 2 layers x 5 us
    assert decode_attn_roofline(rec) == pytest.approx(
        100 * least / (calls * 30e-6))
    assert least_bytes(d, 2, 65) == (2 * 2 * 65 * 4 * 128
                                     + 2 * 2 * 32 * 128) * 2


def test_a_count_that_does_not_match_the_steps_reads_nothing():
    assert decode_attn_roofline(_record(_trace(gen=3), gen=4)) is None
    assert decode_attn_roofline(_record(_trace(n_attn=1))) is None


def test_a_program_without_the_kernels_or_a_trace_reads_nothing():
    rec = _record(_trace())
    rec["trace"]["traceEvents"] = [
        e for e in rec["trace"]["traceEvents"]
        if "decode_attn" not in e["name"]]
    assert decode_attn_roofline(rec) is None
    assert decode_attn_roofline(_record(None)) is None


def test_a_windowed_layer_reads_its_ring():
    rec = _record(_trace())
    cfg = cells.load_json(cells.HERE / "configs" / "yi-6b.json")
    d = rec["dims"] = cells.dims(dict(
        cfg, num_hidden_layers=2, sliding_window=16,
        layer_types=["sliding_attention", "full_attention"]))
    # the windowed layer reads its 16 slots, the global one 65..67
    least = sum(least_bytes(d, 2, 16) + least_bytes(d, 2, 64 + j + 1)
                for j in range(3)) / PEAK_BYTES
    assert decode_attn_roofline(rec) == pytest.approx(100 * least / 30e-6)
