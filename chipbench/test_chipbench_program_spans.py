"""The readers of the program's own regions on hand-made Kineto traces."""
from __future__ import annotations

import pytest

from chipbench import program_spans as ps
from chipbench.run import metric_reader

# every metric that reads the program's regions, by its reader
METRICS = {
    "serve.alloc_cache_ms": ps.alloc_cache_ms,
    "serve.alloc_cache_ms.tokens": ps.alloc_cache_ms,
    "serve.capture_ms": ps.capture_ms,
    "serve.capture_ms.tokens": ps.capture_ms,
    "device.idle_unnamed_share.serve": ps.idle_unnamed_share,
    "device.idle_unnamed_share.serve_tokens": ps.idle_unnamed_share,
    "moe.prefill_ms": ps.moe_prefill_ms,
    "moe.expert_gemm_share": ps.moe_expert_gemm_share,
}


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def _launch(ts, corr, ran, dur, name="k"):
    """A runtime call at ``ts`` and the kernel it launched, running
    ``ran``..``ran + dur`` us."""
    return [_ev("cuda_runtime", "cudaLaunchKernel", ts, 2, correlation=corr),
            _ev("kernel", name, ran, dur, tid=7, correlation=corr,
                stream=7)]


def _trace(capture=True, moe=True):
    """One call (100..1100 us) in a 2000 us window. Regions: alloc_cache
    50 us; capture 300 us (warm-up, with an aten op in it, begin, record,
    end); prefill 340 us, with moe/route, moe/experts and moe/combine in
    it; readback 20; one decode step 80; finish 100; the last 100 us of
    the call under no region. Spans that follow one another inside a
    region leave 1 us between them (the frozen reader nests a span in one
    that ends where it starts). Kernels: one under warm-up > moe/experts
    (180..230), one under record > moe/experts (340..350), route 30 us,
    experts 80 us, combine 10 us, another prefill kernel 80 us, a decode
    kernel 50 us."""
    ev = [_span("device_timeline/window", 0, 2000),
          _span("chipbench/call", 100, 1000),
          _span("serve/alloc_cache", 110, 50),
          _span("serve/prefill", 460, 340),
          _span("serve/prefill_readback", 800, 20),
          _span("serve/decode_step", 820, 80),
          _span("serve/finish", 900, 100),
          *_launch(700, 6, 700, 80),
          *_launch(830, 7, 830, 50)]
    if capture:
        ev += [_span("serve/capture", 160, 300),
               _span("serve/capture/warmup", 165, 99),
               _span("moe/experts", 168, 10),
               _ev("cpu_op", "aten::mm", 240, 60),
               _span("serve/capture/begin", 265, 49),
               _span("serve/capture/record", 315, 84),
               _span("moe/experts", 320, 20),
               _span("serve/capture/end", 400, 55),
               *_launch(170, 1, 180, 50),
               *_launch(330, 2, 340, 10)]
    if moe:
        ev += [_span("moe/route", 500, 19),
               _span("moe/experts", 520, 79),
               _span("moe/combine", 600, 20),
               *_launch(505, 3, 510, 30),
               *_launch(530, 4, 540, 80, name="nvjet_gemm"),
               *_launch(610, 5, 620, 10)]
    return {"traceEvents": ev}


def _record(trace, n_calls=1):
    call = {"n": 2, "P": 64, "gen": 1, "t0_ns": 0, "t1_ns": 1_000_000,
            "prefill_start_ns": 460_000, "prefill_ms": 0.34,
            "decode_ms_mean": 0.05, "requests": [0, 1]}
    return {"kind": "serve", "dims": {}, "mix": {},
            "calls": [dict(call) for _ in range(n_calls)], "trace": trace}


def test_every_metric_file_binds_its_reader():
    for name, fn in METRICS.items():
        assert metric_reader(name) is fn


def test_every_reader_finds_nothing_without_a_trace_or_a_call():
    for fn in set(METRICS.values()):
        assert fn(_record(None)) is None
        assert fn(_record(_trace(), n_calls=0)) is None
        assert fn({"kind": "train", "steps": [{}], "trace": _trace()}) is None


def test_region_readers_by_hand():
    rec = _record(_trace())
    assert ps.alloc_cache_ms(rec) == pytest.approx(0.05)
    assert ps.capture_ms(rec) == pytest.approx(0.3)
    # the same spans over two calls: the mean a call halves
    assert ps.capture_ms(_record(_trace(), n_calls=2)) == pytest.approx(0.15)
    assert ps.region_ms(rec, "serve/capture/begin") == pytest.approx(0.049)


def test_a_call_with_no_capture_reads_zero():
    rec = _record(_trace(capture=False))
    assert ps.capture_ms(rec) == 0.0
    assert ps.alloc_cache_ms(rec) == pytest.approx(0.05)


def test_idle_unnamed_share_by_hand():
    # busy in the call: 180-230, 340-350, 510-630, 700-780, 830-880; idle
    # 80 + 110 + 160 + 70 + 50 + 220 = 690 us, of which 100-110 and
    # 1000-1100 (under chipbench/call alone) lie under no serve/* span;
    # 230-340, under an aten op inside serve/capture, counts as named
    rec = _record(_trace())
    assert ps.idle_unnamed_share(rec) == pytest.approx(100 * 110 / 690)


def test_idle_under_the_call_alone_is_unnamed():
    tr = {"traceEvents": [_span("device_timeline/window", 0, 1000),
                          _span("chipbench/call", 100, 400),
                          _span("serve/prefill", 100, 200),
                          *_launch(110, 1, 110, 100)]}
    # idle 100-110 and 210-500 in the call: 300-500 under no serve/* span
    assert ps.idle_unnamed_share(_record(tr)) == pytest.approx(
        100 * 200 / 300)
    busy = {"traceEvents": [_span("device_timeline/window", 0, 1000),
                            _span("chipbench/call", 100, 400),
                            *_launch(100, 1, 90, 420)]}
    assert ps.idle_unnamed_share(_record(busy)) is None


def test_moe_readers_by_hand():
    # route 30 + experts 80 + combine 10 us in the prefill; the kernels
    # under warm-up and record, and the prefill's other kernel, left out
    rec = _record(_trace())
    assert ps.moe_prefill_ms(rec) == pytest.approx(0.12)
    assert ps.moe_expert_gemm_share(rec) == pytest.approx(100 * 80 / 120)
    assert ps.moe_prefill_ms(_record(_trace(), n_calls=2)) == pytest.approx(
        0.06)


def test_moe_readers_find_nothing_without_moe_spans():
    for capture in (True, False):
        rec = _record(_trace(capture=capture, moe=False))
        assert ps.moe_prefill_ms(rec) is None
        assert ps.moe_expert_gemm_share(rec) is None


def test_minus_of_interval_lists():
    assert ps._minus([(0, 10), (20, 30)], [(5, 8), (9, 22), (25, 40)]) == [
        (0, 5), (8, 9), (22, 25)]
    assert ps._minus([(0, 10)], []) == [(0, 10)]
    assert ps._minus([(0, 10)], [(0, 10)]) == []
