"""The arithmetic of the per-layer metrics, over the record of a traced
run: ``kind``, ``dims``, the mix, the calls or steps with their host
times and the program's own spans, and the Kineto ``trace``. Each
metric's file under ``metrics/`` binds one of these as its ``read``.

A reader returns None where it finds nothing to read: no trace (a run
off the card), no call or step, or kernels other than the ones it counts
for (a kernel renamed, merged or taken off the path).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .frozen import work
from .frozen.peaks import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_EX2, PEAK_F32_FLOPS
from .tracing import busy_within, kernels


def _calls(rec: Dict) -> List[Dict]:
    if rec.get("trace") is None or rec.get("kind") != "serve":
        return []
    return rec["calls"]


def _steps(rec: Dict) -> List[Dict]:
    if rec.get("trace") is None or rec.get("kind") != "train":
        return []
    return rec["steps"]


def _n_layers(d: Dict, mixer: str) -> int:
    return sum(m == mixer for m, _ in d["layers"])


def pre_prefill_ms(rec: Dict) -> Optional[float]:
    """Mean host ms from a call's start to its ``serve/prefill`` region:
    the cache's allocation and the decode graph's capture."""
    gaps = [(c["prefill_start_ns"] - c["t0_ns"]) / 1e6 for c in _calls(rec)
            if c["prefill_start_ns"] is not None]
    return sum(gaps) / len(gaps) if gaps else None


def prefill_mfu(rec: Dict) -> Optional[float]:
    """Model FLOPs of the prefills over their ``serve/prefill`` regions'
    seconds at the bf16 peak, in %."""
    calls = _calls(rec)
    if not calls:
        return None
    flops = sum(work.prefill_flops(rec["dims"], c["n"], c["P"]) for c in calls)
    secs = sum(c["prefill_ms"] for c in calls) / 1e3
    return 100.0 * flops / (secs * PEAK_BF16_FLOPS)


def decode_step_ms(rec: Dict) -> Optional[float]:
    """Mean device ms of a decode step (the program's CUDA events around
    each step), over every step of the traced calls."""
    calls = [c for c in _calls(rec) if c["decode_ms_mean"] is not None]
    steps = sum(c["gen"] for c in calls)
    if not steps:
        return None
    return sum(c["decode_ms_mean"] * c["gen"] for c in calls) / steps


def decode_hbm_share(rec: Dict) -> Optional[float]:
    """Bytes the decode steps must move (weights, the filled cache, the
    states) over their time at the HBM's peak, in %."""
    calls = [c for c in _calls(rec) if c["decode_ms_mean"] is not None]
    if not calls:
        return None
    d = rec["dims"]
    nbytes = sum(work.decode_bytes(d, c["n"], c["P"] + j + 1)
                 for c in calls for j in range(c["gen"]))
    secs = sum(c["decode_ms_mean"] * c["gen"] for c in calls) / 1e3
    return 100.0 * nbytes / (secs * PEAK_BYTES)


def serve_mfu(rec: Dict) -> Optional[float]:
    """Model FLOPs of whole calls (prefill and every decode step) over
    the calls' host seconds at the bf16 peak, in %."""
    calls = _calls(rec)
    if not calls:
        return None
    d = rec["dims"]
    flops = sum(work.prefill_flops(d, c["n"], c["P"])
                + sum(work.decode_flops(d, c["n"], c["P"] + j + 1)
                      for j in range(c["gen"])) for c in calls)
    secs = sum(c["t1_ns"] - c["t0_ns"] for c in calls) / 1e9
    return 100.0 * flops / (secs * PEAK_BF16_FLOPS)


def flash_roofline_serve(rec: Dict) -> Optional[float]:
    """The flash forward's share of its roofline over the prefills: the
    least time of every launch (FLOPs or bytes from its shape and its
    layer's window) over the kernels' time in the trace, in %."""
    calls = _calls(rec)
    d = rec.get("dims", {})
    ks = kernels(rec, "flash_fwd")
    n_attn = _n_layers(d, "attn") if calls else 0
    if not ks or len(ks) != n_attn * len(calls):
        return None
    H, K, D = d["n_heads"], d["n_kv_heads"], d["head_dim"]
    least = sum(sum(n_w * work.least_s(
        *work.attention_work(c["n"], c["P"], c["P"], H, K, D, True, w, 2),
        PEAK_BF16_FLOPS, PEAK_BYTES)
        for w, n_w in work.attn_windows(d).items()) for c in calls)
    return 100.0 * least / (sum(k["us"] for k in ks) / 1e6)


def scan_roofline_serve(rec: Dict) -> Optional[float]:
    """The selective scan forward's share of its roofline over the
    prefills (f32 FLOPs, ex2 on the SFU, bytes), in %."""
    calls = _calls(rec)
    d = rec.get("dims", {})
    ks = kernels(rec, "selective_scan", exclude="bwd")
    n_mamba = _n_layers(d, "mamba") if calls else 0
    if not ks or not n_mamba or len(ks) != n_mamba * len(calls):
        return None
    least = 0.0
    for c in calls:
        flops, exps, nbytes = work.scan_work(c["n"], c["P"], d["d_inner"],
                                             d["d_state"], 2, 4)
        least += n_mamba * work.least_s(flops, nbytes, PEAK_F32_FLOPS,
                                        PEAK_BYTES, exps, PEAK_EX2)
    return 100.0 * least / (sum(k["us"] for k in ks) / 1e6)


def idle_share_calls(rec: Dict) -> Optional[float]:
    """Share of the calls' time (the harness's ``chipbench/call`` spans)
    in which no kernel, copy or fill ran on the card, in %."""
    if not _calls(rec):
        return None
    t = busy_within(rec["trace"], "chipbench/call")
    if not t["span_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])


def idle_share_steps(rec: Dict) -> Optional[float]:
    """Share of the traced steps' time (``chipbench/step`` spans) with
    nothing on the card, in %."""
    if not _steps(rec):
        return None
    t = busy_within(rec["trace"], "chipbench/step")
    if not t["span_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])


def train_step_mfu(rec: Dict) -> Optional[float]:
    """Model FLOPs of the traced steps (no recompute counted) over their
    host seconds at the bf16 peak, in %."""
    steps = _steps(rec)
    if not steps:
        return None
    d, mix = rec["dims"], rec["mix"]
    flops = len(steps) * work.train_flops(d, mix["batch"], mix["seq_len"])
    secs = sum(s["t1_ns"] - s["t0_ns"] for s in steps) / 1e9
    return 100.0 * flops / (secs * PEAK_BF16_FLOPS)


def train_update_ms(rec: Dict) -> Optional[float]:
    """Device ms a step of the kernels launched under ``train/update``
    (the optimizer)."""
    steps = _steps(rec)
    if not steps:
        return None
    ks = [k for k in kernels(rec, "") if "train/update" in k["spans"]]
    if not ks:
        return None
    return sum(k["us"] for k in ks) / 1e3 / len(steps)


def flash_roofline_train(rec: Dict) -> Optional[float]:
    """The flash kernels' share of their roofline over the traced steps:
    the forward (and its recompute), dq and dk/dv, each layer at its
    window, in %."""
    steps = _steps(rec)
    if not steps:
        return None
    d, mix = rec["dims"], rec["mix"]
    fwd = kernels(rec, "flash_fwd")
    dq = kernels(rec, "flash_bwd_dq")
    dkv = kernels(rec, "flash_bwd_dkv")
    n = _n_layers(d, "attn") * len(steps)
    if not (fwd and dq and dkv) or len(dq) != n or len(dkv) != n \
            or len(fwd) % n:
        return None
    B, T = mix["batch"], mix["seq_len"]
    H, K, D = d["n_heads"], d["n_kv_heads"], d["head_dim"]
    n_attn = _n_layers(d, "attn")
    least = 0.0
    for w, n_w in work.attn_windows(d).items():
        # each layer's share of the launches: its forward (and recompute)
        # len(fwd) / n_attn times, dq and dk/dv once a step
        bwd = work.backward_work(B, T, T, H, K, D, True, w, 2)
        least += (len(fwd) * n_w // n_attn * work.least_s(
            *work.attention_work(B, T, T, H, K, D, True, w, 2),
            PEAK_BF16_FLOPS, PEAK_BYTES)
            + n_w * len(steps) * work.least_s(*bwd["dq"], PEAK_BF16_FLOPS,
                                              PEAK_BYTES)
            + n_w * len(steps) * work.least_s(*bwd["dkv"], PEAK_BF16_FLOPS,
                                              PEAK_BYTES))
    secs = sum(k["us"] for k in fwd + dq + dkv) / 1e6
    return 100.0 * least / secs
