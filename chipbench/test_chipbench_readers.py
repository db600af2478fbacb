"""The per-layer readers on a hand-made record and Kineto trace."""
from __future__ import annotations

import pytest

from chipbench import cells, readers
from chipbench.frozen import work
from chipbench.frozen.peaks import PEAK_BF16_FLOPS, PEAK_BYTES
from chipbench.tracing import breakdown, device_times


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace():
    """One call span (100..600 us) in a 1000 us window: two flash forward
    launches of 100 us each and a 50 us GEMM inside it, one 20 us copy
    outside it."""
    return {"traceEvents": [
        _ev("user_annotation", "device_timeline/window", 0, 1000),
        _ev("user_annotation", "chipbench/call", 100, 500),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 130, 5, correlation=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 700, 5, correlation=4),
        _ev("kernel", "void flash_fwd_wgmma_kernel<128>()", 200, 100, tid=7,
            correlation=1, stream=7),
        _ev("kernel", "void flash_fwd_wgmma_kernel<128>()", 300, 100, tid=7,
            correlation=2, stream=7),
        _ev("kernel", "nvjet_gemm", 450, 50, tid=7, correlation=3, stream=7),
        _ev("gpu_memcpy", "Memcpy DtoH", 800, 20, tid=7, correlation=4,
            stream=7),
    ]}


def _record(trace):
    cfg = cells.load_json(cells.HERE / "configs" / "yi-6b.json")
    d = cells.dims(dict(cfg, num_hidden_layers=2))
    call = {"n": 2, "P": 64, "gen": 3, "t0_ns": 0, "t1_ns": 2_000_000,
            "prefill_start_ns": 500_000, "prefill_ms": 1.0,
            "decode_ms_mean": 0.25, "requests": [0, 1]}
    return {"kind": "serve", "dims": d, "mix": {}, "calls": [call],
            "trace": trace}


def test_readers_find_nothing_without_a_trace():
    rec = _record(None)
    for fn in (readers.pre_prefill_ms, readers.prefill_mfu,
               readers.flash_roofline_serve, readers.idle_share_calls,
               readers.train_step_mfu, readers.train_update_ms):
        assert fn(rec) is None


def test_serving_readers_by_hand():
    rec = _record(_trace())
    d = rec["dims"]
    assert readers.pre_prefill_ms(rec) == 0.5
    assert readers.decode_step_ms(rec) == 0.25
    flops = work.prefill_flops(d, 2, 64)
    assert readers.prefill_mfu(rec) == pytest.approx(
        100 * flops / (1e-3 * PEAK_BF16_FLOPS))
    least = 2 * work.least_s(*work.attention_work(2, 64, 64, 32, 4, 128,
                                                  True, None, 2),
                             PEAK_BF16_FLOPS, PEAK_BYTES)
    assert readers.flash_roofline_serve(rec) == pytest.approx(
        100 * least / 200e-6)
    # 250 of the call's 500 us busy
    assert readers.idle_share_calls(rec) == pytest.approx(50.0)


def test_a_kernel_count_that_does_not_match_reads_nothing():
    rec = _record(_trace())
    rec["calls"].append(dict(rec["calls"][0]))
    assert readers.flash_roofline_serve(rec) is None


def test_device_times_and_breakdown():
    tr = _trace()
    assert device_times(tr) == {"busy_s": pytest.approx(270e-6),
                                "window_s": pytest.approx(1000e-6)}
    b = breakdown(tr)
    assert b["device_ops"][0] == ["void flash_fwd_wgmma_kernel<128>()",
                                  pytest.approx(200e-6)]
    assert len(b["idle_gaps"]) <= 10 and b["idle_gaps"][0][1] > 0


def test_a_windowed_layer_reads_its_window():
    rec = _record(_trace())
    cfg = cells.load_json(cells.HERE / "configs" / "yi-6b.json")
    rec["dims"] = cells.dims(dict(
        cfg, num_hidden_layers=2, sliding_window=16,
        layer_types=["sliding_attention", "full_attention"]))
    least = sum(work.least_s(*work.attention_work(2, 64, 64, 32, 4, 128,
                                                  True, w, 2),
                             PEAK_BF16_FLOPS, PEAK_BYTES) for w in (16, None))
    assert readers.flash_roofline_serve(rec) == pytest.approx(
        100 * least / 200e-6)
    assert readers.prefill_mfu(rec) == pytest.approx(
        100 * work.prefill_flops(rec["dims"], 2, 64)
        / (1e-3 * PEAK_BF16_FLOPS))
    assert work.prefill_flops(rec["dims"], 2, 64) < work.prefill_flops(
        _record(None)["dims"], 2, 64)
