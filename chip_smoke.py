#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final line):
  1. the card: name, count, power limit (nvidia-smi);
  2. build the CUDA kernels (flash-attention forward; backward dq and
     dk/dv; selective scan) from this checkout's sources, one nvcc per
     source, in parallel; print what ptxas says of each instantiation
     (registers, spills), the dynamic shared memory and blocks an SM of
     the bf16 tensor-core (wgmma) forward, dq and dk/dv kernels and of
     the scan, and check in the scan's SASS (cuobjdump) that every
     special-function instruction is one MUFU.EX2, four to a step (one a
     state);
  3. hold one 64 x N x 16 wgmma product to torch.matmul, then the forward
     kernel to its plain PyTorch version on the card: the yi-6b serving
     shape (B=4, T=1024, H=32, K=4, D=128, bf16, causal), a ragged length,
     a window, non-causal, the jamba prefill's K=8, f32 at D=64, and bf16
     at D=32 and 64, T of 1
     and 17, a window of 48 that starts inside a tile, non-causal S != T,
     and G = H/K of 1 and 8; every bf16 case must launch the wgmma
     variant and every f32 case the scalar one;
  4. time the forward kernel, its plain version and PyTorch's
     scaled_dot_product_attention (yardstick only) at the serving shape,
     with CUDA events, turn about; compute the least time the card could
     take;
  5. the port's model on the card against the same model on the CPU at
     full yi-6b width, two layers, f32 (scalar kernels); then serve yi-6b
     at full width through ``repro_torch.launch.serve.main`` (batch 4,
     prompt 1024, 32 generated tokens) and check that every prefill
     attention went through the wgmma forward;
  6. hold the dq and dk/dv kernels to the plain backward on the card: the
     yi-6b training shape (the serving shape above), a ragged length, a
     window, non-causal, jamba's K=8, f32 at D=64, and the bf16 cases of
     phase 3 (T of 1 as non-causal S != T); bf16 must launch the wgmma
     dq and dk/dv, f32 the scalar ones; two launches of the wgmma dq on
     the training shape must give bit-identical dq;
  7. time both backward kernels, the plain backward and the backward of
     scaled_dot_product_attention (yardstick only) at the training shape;
  8. one train step of the port on the card against the same step on the
     CPU at full yi-6b width, two layers, f32: the loss and every gradient;
  9. train yi-6b at full width and 8 of its 32 layers through
     ``repro_torch.launch.train.main`` (batch 4, seq 1024, 6 steps, bf16
     compute, f32 master weights, full remat, AdamW) and check the kernel
     launches of every step: 2 forward (the forward and the remat
     recompute), 1 dq and 1 dk/dv per layer, all on the wgmma variants;
 10. hold the selective-scan kernel to its plain PyTorch version on the
     card: the jamba serving shape (B=4, T=1024, d_inner 8192, d_state 16,
     x bf16, dt/B/C f32), a ragged length and width, f32, all-bf16, and
     d_state 4 and 8 at the serving width (one and two lanes a channel);
 11. time the scan kernel and its plain version at the serving shape, with
     CUDA events; compute the least time the card could take;
 12. the port's jamba model on the card against the same model on the CPU:
     full mixer width, one pattern group (8 layers), f32, with the MoE
     expert width and the MLP width cut to 512;
 13. serve jamba-v0.1-52b at full width and 16 of its 32 layers through
     ``repro_torch.launch.serve.generate`` (batch 4, prompt 1024, 32
     generated tokens) and check that every mamba prefill went through the
     scan kernel and every attention prefill through the wgmma forward;
 14. print one JSON line with every ported kernel, then the result line.

Exits non-zero without a result line when no CUDA card is present or the
port is not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores,
# f32 outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# special-function unit (ex2) results per clock per SM, compute capability
# 9.0 (CUDA C++ programming guide, arithmetic instruction throughput)
SFU_PER_CLOCK_SM = 16

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "src/repro_torch/kernels/flash_attention/csrc/"
KERNEL_SOURCE = CSRC + "flash_fwd.cu"
BWD_SOURCE = CSRC + "flash_bwd.cu"
TPU_KERNEL = "src/repro/kernels/flash_attention/kernel.py:90"
TPU_DQ = "src/repro/kernels/flash_attention/kernel.py:223"
TPU_DKV = "src/repro/kernels/flash_attention/kernel.py:241"
SCAN_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/selective_scan.cu"
TPU_SCAN = "src/repro/kernels/mamba_scan/kernel.py:49"
OUT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX package's bounds
LSE_TOL = 1e-3       # f32 on both sides, sums over up to 1024 keys
MODEL_TOL = 1e-3     # f32 logits over 4096-wide sums, card vs CPU
# gradients: max|err| / max|ref|; f32 the JAX package's bound
# (tests/test_kernels_flash.py), bf16 the rounding of 8-bit mantissas
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_GRAD_TOL = 1e-3  # f32 train step card vs CPU, per gradient, relative
TRAIN_LOSS_TOL = 1e-4  # f32 loss card vs CPU, absolute
TRAIN_LAYERS = 8     # of yi-6b's 32: 16 B/param of f32 state must fit 80 GB
# the scan's y against the plain version's f32 y: the JAX package's bounds
# (tests/test_kernels_mamba.py) beyond the rounding of y to its dtype, at
# most 2^-8 of |y| in bf16 (8 bits of mantissa) and 2^-24 in f32; |y|
# reaches ~80 at the serving shape, where bf16 rounding alone is 0.25.
# The final state is f32 on both sides.
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SCAN_ROUNDING = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}
SCAN_STATE_TOL = 1e-4
JAMBA_LAYERS = 16    # of jamba's 32: 52 GB of bf16 weights; 32 need ~103 GB
JAMBA_CHECK_WIDTH = 512  # d_expert and d_ff of the card-vs-CPU jamba model
# each kernel's design on the bf16 main paths
DESIGN = {"flash_attention_fwd": "wgmma", "flash_attention_bwd_dq": "wgmma",
          "flash_attention_bwd_dkv": "wgmma",
          "selective_scan": "states split over lanes, cp.async ring"}
# bf16 edge cases of phases 3 and 6: head dims 32 and 64, lengths shorter
# than a tile and not multiples of it, a window that starts inside a 64-key
# tile, non-causal S != T, and G = H/K of 1 and 8 (K = 2 and 4)
_SMALL = dict(B=2, T=200, H=16, K=2, D=128, dtype="bfloat16", causal=True,
              window=None)
SMALL_BF16_CASES = [
    ("bf16 D=64 T=17 G=8", dict(_SMALL, T=17, D=64)),
    ("bf16 D=32 T=200", dict(_SMALL, D=32)),
    ("bf16 T=1000 window=48", dict(_SMALL, T=1000, window=48)),
    ("bf16 D=64 T=200 G=1", dict(_SMALL, D=64, H=2)),
    ("bf16 T=1 S=33 non-causal", dict(_SMALL, T=1, S=33, causal=False)),
    ("bf16 T=160 S=300 non-causal", dict(_SMALL, T=160, S=300, causal=False,
                                          H=16, K=4)),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def unmasked_pairs(T, S, causal, window):
    """(query, key) pairs that the causal/window mask lets through."""
    pairs = 0
    for t in range(T):
        hi = min(t, S - 1) if causal else S - 1
        lo = max(0, t - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def least_ms(flops, nbytes, peak):
    """Least time: the larger of the FLOP over the peak rate and the bytes
    over the memory rate. Returns (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bound_ms(B, T, S, H, K, D, causal, window, itemsize, peak):
    """Least time for one forward call: useful FLOP (4·D per unmasked
    (q, k) pair per head: s and p·v) and bytes (q, k, v read once; out,
    lse written once)."""
    flops = 4 * D * B * H * unmasked_pairs(T, S, causal, window)
    nbytes = (2 * B * T * H * D + 2 * B * S * K * D) * itemsize + B * H * T * 4
    ms, by = least_ms(flops, nbytes, peak)
    return ms, by, flops, nbytes


def backward_bound_ms(B, T, S, H, K, D, causal, window, itemsize, peak):
    """Least time of each backward kernel: useful FLOP 6·D per unmasked
    pair per head for dq (s, dp, ds·k) and 8·D for dk/dv (s, dp, pᵀ·do,
    dsᵀ·q); bytes: q, k, v, do, lse, delta read once, dq (or dk, dv)
    written once. Returns {"dq": (ms, by, flops, bytes), "dkv": ...}."""
    pairs = B * H * unmasked_pairs(T, S, causal, window)
    reads = ((2 * B * T * H * D + 2 * B * S * K * D) * itemsize
             + 2 * B * H * T * 4)
    out = {}
    for name, per_pair, written in (("dq", 6, B * T * H * D),
                                    ("dkv", 8, 2 * B * S * K * D)):
        flops = per_pair * D * pairs
        nbytes = reads + written * itemsize
        out[name] = (*least_ms(flops, nbytes, peak), flops, nbytes)
    return out


def ptxas_report(log: str):
    """(kernel<types,size>, "N registers, spills") per instantiation, from
    the ``-Xptxas -v`` report of a build."""
    import re

    types = {"f": "f32", "13__nv_bfloat16": "bf16"}
    entry, spills = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            u = re.search(r"(selective_scan_kernel)I(f|13__nv_bfloat16)"
                          r"(f|13__nv_bfloat16|S\d*_)Li(\d+)E", entry)
            w = re.search(r"((?:flash_fwd_wgmma|flash_fwd_f32|"
                          r"flash_bwd_dq_wgmma|flash_bwd_dq_f32|"
                          r"flash_bwd_dkv_wgmma|flash_bwd_dkv_f32|"
                          r"wgmma_probe)_kernel)"
                          r"ILi(\d+)E", entry)
            if w:
                entry = f"{w.group(1)}<{w.group(2)}>"
            elif u:
                # a repeated type is a substitution (S<n>_): bf16, bf16
                entry = (f"{u.group(1)}<x {types[u.group(2)]}, dt/B/C "
                         f"{types.get(u.group(3), types[u.group(2)])}, "
                         f"N={u.group(4)}>")
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield entry, f"{line.split(':', 1)[-1].strip()}; {spills}"


def scan_bound_ms(B, T, dI, N, x_item, p_item, sms, clock_hz):
    """Least time for one scan call. Bytes: x, dt, B, C, A, D read once, y
    and the final state written once. Operations: 6 f32 flops per (b, t,
    d, n) (dt·A, dx·B, two FMAs) and 3 per (b, t, d) (dt·x, an FMA with
    D), at the f32 peak; and one ex2 per (b, t, d, n) on the SFU, at
    ``SFU_PER_CLOCK_SM`` a clock on each SM at the card's top SM clock.
    Returns (ms, what bounds it, detail)."""
    nbytes = (B * T * dI * (2 * x_item + p_item) + 2 * B * T * N * p_item
              + dI * N * 4 + dI * 4 + B * dI * N * 4)
    flops = B * T * dI * (6 * N + 3)
    exps = B * T * dI * N
    t_bytes = nbytes / PEAK_BYTES
    t_flops = flops / PEAK_F32_FLOPS
    t_exps = exps / (sms * SFU_PER_CLOCK_SM * clock_hz)
    t_ops = max(t_flops, t_exps)
    detail = (f"{nbytes / 1e6:.1f} MB -> {t_bytes * 1e3:.4f} ms; "
              f"{flops:.3e} f32 flops -> {t_flops * 1e3:.4f} ms; "
              f"{exps:.3e} ex2 at {sms} SMs x {SFU_PER_CLOCK_SM} x "
              f"{clock_hz / 1e6:.0f} MHz -> {t_exps * 1e3:.4f} ms")
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", detail)


def rel_err(a, b) -> float:
    """max|a - b| / max|b|, in f32."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters

def _counted():
    """(kernel name, wrapper function, launch counter on it) of every
    kernel."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba_scan.ops import selective_scan

    return (("flash_attention_fwd", flash_attention, "launches"),
            ("flash_attention_bwd_dq", flash_attention, "bwd_dq_launches"),
            ("flash_attention_bwd_dkv", flash_attention, "bwd_dkv_launches"),
            ("selective_scan", selective_scan, "launches"))


def reset_counts() -> None:
    """Set every kernel's launch count, and the flash kernels' counts by
    variant, to 0, just before a path runs."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    for _, fn, attr in _counted():
        setattr(fn, attr, 0)
    for key in flash_attention.launches_by_variant:
        flash_attention.launches_by_variant[key] = 0


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in _counted()}


def read_variants() -> dict:
    """The flash kernels' launches by variant that were made, e.g.
    {"fwd/wgmma": 32}."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    return {k: n for k, n in flash_attention.launches_by_variant.items() if n}


def variants_of(cases: dict) -> dict:
    """The variant counts that a run of the given launches must show;
    ``cases`` maps (kernel, dtype) to a count. Every bf16 launch of the
    forward, dq and dk/dv runs on the tensor cores (wgmma), every f32
    launch on the scalar kernels."""
    want = {}
    for (name, dtype), n in cases.items():
        key = f"{name}/{'wgmma' if dtype == 'bfloat16' else 'scalar'}"
        want[key] = want.get(key, 0) + n
    return {k: n for k, n in want.items() if n}


def backward_phases(qkv) -> dict:
    """Phases 6 and 7: the dq and dk/dv kernels against the plain backward
    on the card, then their times at the training shape."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    training = dict(B=4, T=1024, H=32, K=4, D=128, dtype="bfloat16",
                    causal=True, window=None)
    cases = [
        ("training", training),
        ("ragged T=1000", dict(training, T=1000)),
        ("window=256", dict(training, window=256)),
        ("non-causal", dict(training, causal=False)),
        ("jamba K=8", dict(training, K=8)),
        ("f32 D=64", dict(B=2, T=512, H=8, K=2, D=64, dtype="float32",
                          causal=True, window=None)),
        *SMALL_BF16_CASES,
    ]

    def inputs(c):
        q, k, v = qkv(c["B"], c["T"], c["H"], c["K"], c["D"], c["dtype"],
                      c.get("S"))
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        out, lse = ref.flash_attention_ref(q, k, v, causal=c["causal"],
                                           window=c["window"])
        return q, k, v, out, lse, do

    result = {"abs_err": {}, "rel_err": {}}
    for label, c in cases:
        q, k, v, out, lse, do = inputs(c)
        mask = dict(causal=c["causal"], window=c["window"])
        reset_counts()
        got = ops.flash_attention_bwd(q, k, v, out, lse, do, **mask)
        torch.cuda.synchronize()
        used = read_variants()
        want_used = variants_of({("dq", c["dtype"]): 1, ("dkv", c["dtype"]): 1})
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **mask)
        rels = [rel_err(a, b) for a, b in zip(got, want)]
        abss = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        tol = GRAD_TOL[c["dtype"]]
        ok = all(r < tol for r in rels) and all(
            a.dtype == b.dtype and a.shape == b.shape
            for a, b in zip(got, want)) and used == want_used
        print(f"[6] {label:22s} dq/dk/dv max|err|/max|ref| "
              f"{rels[0]:.3e} / {rels[1]:.3e} / {rels[2]:.3e} (< {tol:g}), "
              f"max|err| {abss[0]:.3e} / {abss[1]:.3e} / {abss[2]:.3e}; "
              f"{used} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"backward kernels disagree with the plain version: {label}")
        if label == "training":
            result["abs_err"] = {"dq": abss[0], "dkv": max(abss[1:])}
            result["rel_err"] = {"dq": rels[0], "dkv": max(rels[1:])}
            # each block owns its dq tile: no atomics, the same bits twice
            delta = (do.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            lse_c = lse.contiguous()
            twice = [kernel.flash_bwd_dq(q, k, v, do, lse_c, delta)
                     for _ in range(2)]
            torch.cuda.synchronize()
            same = torch.equal(*twice)
            print(f"[6] training dq, two launches bit-identical: {same}",
                  flush=True)
            check(same, "two launches of the dq kernel differ")
            del delta, lse_c, twice
        del q, k, v, out, lse, do, got, want
    torch.cuda.empty_cache()

    # 7. timing at the training shape, turn about: kernels, plain, library,
    # kernels again
    c = training
    q, k, v, out, lse, do = inputs(c)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    run_dq = lambda: kernel.flash_bwd_dq(q, k, v, do, lse, delta)
    run_dkv = lambda: kernel.flash_bwd_dkv(q, k, v, do, lse, delta)
    dq_ms, dkv_ms = cuda_ms(run_dq), cuda_ms(run_dkv)
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse,
                                                           do), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                 retain_graph=True))
    dq2_ms, dkv2_ms = cuda_ms(run_dq), cuda_ms(run_dkv)
    bounds = backward_bound_ms(c["B"], c["T"], c["T"], c["H"], c["K"], c["D"],
                               True, None, 2, PEAK_BF16_FLOPS)
    result["timing"] = {}
    for name, ms, ms2 in (("dq", dq_ms, dq2_ms), ("dkv", dkv_ms, dkv2_ms)):
        b_ms, b_by, flops, nbytes = bounds[name]
        result["timing"][name] = {"ms": ms, "ms_again": ms2, "bound_ms": b_ms,
                                  "bound_by": b_by}
        print(f"[7] training shape: {name} kernel {ms:.3f} / {ms2:.3f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {flops:.3e} FLOP, "
              f"{nbytes / 1e6:.1f} MB), kernel at {b_ms / ms:.2%} of bound",
              flush=True)
    print(f"[7] plain backward (dq, dk, dv together) {plain_ms:.3f} ms; "
          f"sdpa backward (dq, dk, dv together) {lib_ms:.3f} ms", flush=True)
    result["plain_ms"], result["library_ms"] = plain_ms, lib_ms
    del q, k, v, out, lse, do, delta, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    return result


def train_phases():
    """Phase 8: one train step on the card against the CPU; phase 9: the
    training path at the slice's size. Returns (launch counts of the
    training path, its stats)."""
    import math

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    # 8. one train step, card vs CPU, full width, 2 layers, f32
    cfg = dataclasses.replace(get_config("yi-6b", "full"), n_layers=2,
                              dtype="float32")
    m_gpu = Model(cfg, dev, trainable=True).init_weights(0)
    m_cpu = Model(cfg, cpu, trainable=True)
    m_cpu.load_state_dict(m_gpu.state_dict())
    rng = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 101), generator=rng)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, adamw.AdamWConfig())
    t0 = time.perf_counter()
    metrics = []
    reset_counts()
    for m, d in ((m_gpu, dev), (m_cpu, cpu)):
        st = adamw.init_state(dict(m.named_parameters()))
        metrics.append(step(m, st, {k: v.to(d) for k, v in batch.items()}))
    f32_used = read_variants()
    loss_gpu, loss_cpu = (float(x["loss"]) for x in metrics)
    cpu_grads = {n: p.grad for n, p in m_cpu.named_parameters()}
    worst, worst_name = 0.0, ""
    for n, p in m_gpu.named_parameters():
        check(bool(torch.isfinite(p.grad).all()), f"non-finite gradient {n}")
        r = rel_err(p.grad.cpu(), cpu_grads[n])
        if r > worst:
            worst, worst_name = r, n
    print(f"[8] yi-6b width, 2 layers, f32, B=2 T=100: card vs CPU loss "
          f"{loss_gpu:.6f} vs {loss_cpu:.6f} (|diff| < {TRAIN_LOSS_TOL:g}), "
          f"worst gradient max|err|/max|ref| {worst:.3e} ({worst_name}, "
          f"< {TRAIN_GRAD_TOL:g}) over {len(cpu_grads)} gradients, "
          f"{time.perf_counter() - t0:.1f} s; card launches {f32_used}",
          flush=True)
    check(set(f32_used) == {"fwd/scalar", "dq/scalar", "dkv/scalar"},
          f"the f32 train step launched {f32_used}: scalar kernels expected")
    check(abs(loss_gpu - loss_cpu) < TRAIN_LOSS_TOL,
          "train loss on the card disagrees with the CPU")
    check(worst < TRAIN_GRAD_TOL,
          "train gradients on the card disagree with the CPU")
    del m_gpu, m_cpu, cpu_grads, metrics
    torch.cuda.empty_cache()

    # 9. the training path at the slice's size
    steps, B, T = 6, 4, 1024
    reset_counts()
    losses, stats = train.main([
        "--arch", "yi-6b", "--preset", "full", "--layers", str(TRAIN_LAYERS),
        "--batch", str(B), "--seq", str(T), "--steps", str(steps)])
    counts = read_counts()
    L = stats["layers"]
    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L}
    per_step_variants = variants_of({("fwd", "bfloat16"): 2 * L,
                                     ("dq", "bfloat16"): L,
                                     ("dkv", "bfloat16"): L})
    print(f"[9] train yi-6b full width, {L} layers, {stats['params']:,} "
          f"params, B={B} T={T}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"[9] step ms {', '.join(f'{x:.1f}' for x in stats['step_ms'])}; "
          f"mean after the first {stats['mean_step_ms']:.1f} ms, "
          f"{stats['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{stats['peak_memory_bytes']} B "
          f"({stats['peak_memory_bytes'] / 2**30:.2f} GiB); launches {counts}; "
          f"by variant, each step {per_step_variants}", flush=True)
    check(L == TRAIN_LAYERS, f"trained {L} layers, not {TRAIN_LAYERS}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"non-finite or missing train losses: {losses}")
    check(all(s == per_step for s in stats["launches"]),
          f"launches per step {stats['launches']}, expected {per_step}")
    check(all({k: n for k, n in s.items() if n} == per_step_variants
              for s in stats["launches_by_variant"]),
          f"launches by variant per step {stats['launches_by_variant']}, "
          f"expected {per_step_variants}")
    check(counts == {**{k: steps * n for k, n in per_step.items()},
                     "selective_scan": 0},
          f"launches over the run {counts}, expected {steps} x {per_step} "
          "and no scan")
    return counts, stats


def scan_phases(sms: int, clock_hz: float) -> dict:
    """Phases 10 and 11: the scan kernel against its plain version on the
    card, then its time at the serving shape."""
    import torch

    from repro_torch.kernels.mamba_scan import kernel, ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(c):
        """The distribution of tests/test_kernels_mamba.py."""
        rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        xt, pt = getattr(torch, c["x"]), getattr(torch, c["p"])
        B, T, dI, N = c["B"], c["T"], c["dI"], c["N"]
        x = rn(B, T, dI).to(xt)
        dt = torch.nn.functional.softplus(rn(B, T, dI) - 2).to(pt)
        A = -torch.exp(rn(dI, N) * 0.5)
        return x, dt, A, rn(B, T, N).to(pt), rn(B, T, N).to(pt), rn(dI)

    serving = dict(B=4, T=1024, dI=8192, N=16, x="bfloat16", p="float32")
    cases = [
        ("serving", serving),
        ("ragged T=1000 dI=8000", dict(serving, T=1000, dI=8000)),
        ("f32", dict(B=2, T=512, dI=1024, N=16, x="float32", p="float32")),
        ("all-bf16", dict(serving, p="bfloat16")),
        ("d_state 4", dict(serving, N=4)),
        ("d_state 8", dict(serving, N=8)),
    ]
    result = {}
    for label, c in cases:
        args = inputs(c)
        y, h = ops.selective_scan(*args, return_state=True)
        torch.cuda.synchronize()
        y_ref, h_ref = ref.selective_scan_ref(*args)
        err = (y.float() - y_ref).abs()
        e_y = float(err.max())
        beyond = float((err - SCAN_ROUNDING[c["x"]] * y_ref.abs()).max())
        r_y = e_y / float(y_ref.abs().max())
        e_h = float((h - h_ref).abs().max())
        r_h = e_h / float(h_ref.abs().max())
        tol = SCAN_TOL[c["x"]]
        ok = (beyond < tol and e_h < SCAN_STATE_TOL
              and y.dtype == args[0].dtype and y.shape == y_ref.shape
              and h.shape == h_ref.shape)
        print(f"[10] {label:22s} y max|err| {e_y:.3e}, /max|ref| {r_y:.3e} "
              f"(max|ref| {float(y_ref.abs().max()):.1f}), beyond the "
              f"rounding of y {beyond:.3e} (< {tol:g}); state max|err| "
              f"{e_h:.3e} (< {SCAN_STATE_TOL:g}), /max|ref| {r_h:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"scan kernel disagrees with its plain version: {label}")
        result[label] = {"y": e_y, "y_rel": r_y, "y_beyond_rounding": beyond,
                         "state": e_h}
        del err
        del args, y, h, y_ref, h_ref
    torch.cuda.empty_cache()

    # 11. timing at the serving shape, turn about: kernel, plain, kernel
    c = serving
    args = inputs(c)
    run = lambda: kernel.selective_scan(*args, return_state=True)
    k_ms = cuda_ms(run)
    plain_ms = cuda_ms(lambda: ref.selective_scan_ref(*args), iters=3,
                       warmup=1)
    k2_ms = cuda_ms(run)
    bound_ms, bound_by, detail = scan_bound_ms(
        c["B"], c["T"], c["dI"], c["N"], 2, 4, sms, clock_hz)
    print(f"[11] serving shape: kernel {k_ms:.3f} / {k2_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, no single PyTorch call computes a selective "
          f"scan; bound {bound_ms:.4f} ms ({bound_by}: {detail}), kernel at "
          f"{bound_ms / k_ms:.2%} of bound", flush=True)
    del args
    torch.cuda.empty_cache()
    result["timing"] = {"ms": k_ms, "ms_again": k2_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
    return result


def jamba_phases():
    """Phase 12: the jamba model on the card against the CPU; phase 13:
    serve jamba at the slice's size. Returns (launch counts of the serving
    path, its numbers)."""
    import gc

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.core.collector import (global_collector,
                                            reset_global_collector)
    from repro_torch.core.graphframe import GraphFrame
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_decode_step, make_prefill_step

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    full = get_config("jamba-v0.1-52b", "full")
    # 12. one pattern group at full mixer width, f32, narrow FFNs
    W = JAMBA_CHECK_WIDTH
    cfg = dataclasses.replace(full, n_layers=len(full.pattern), d_ff=W,
                              moe=dataclasses.replace(full.moe, d_expert=W),
                              dtype="float32")
    t0 = time.perf_counter()
    m_gpu = Model(cfg, dev).init_weights(0)
    m_cpu = Model(cfg, cpu)
    m_cpu.load_state_dict(m_gpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(0))
    reset_counts()
    with torch.no_grad():
        results = []
        for m, d in ((m_gpu, dev), (m_cpu, cpu)):
            caches = m.alloc_cache(2, 103)
            logits = [make_prefill_step(cfg)(m, {"tokens": toks[:, :97].to(d)},
                                             caches)]
            for t in range(97, 100):
                logits.append(make_decode_step(cfg)(
                    m, caches, {"tokens": toks[:, t:t + 1].to(d)}, t)[0])
            results.append([x.cpu() for x in logits])
    counts = read_counts()
    f32_used = read_variants()
    worst = 0.0
    for a, b in zip(*results):
        check(bool(torch.isfinite(a).all()), "non-finite jamba logits")
        worst = max(worst, float((a - b).abs().max()))
    n_params = sum(p.numel() for p in m_gpu.parameters())
    del m_gpu, m_cpu, results
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[12] jamba, full mixer width (d 4096, d_inner 8192, d_state 16, "
          f"32/8 heads), 8 layers, f32, {n_params:,} params; reduced: "
          f"d_expert and d_ff {W}: card vs CPU logits max|err| {worst:.3e} "
          f"(< {MODEL_TOL:g}) over prefill + 3 decode steps; card launches "
          f"{counts}, {f32_used}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(worst < MODEL_TOL, "jamba on the card disagrees with the CPU")
    check(counts["selective_scan"] == 7 and counts["flash_attention_fwd"] == 1,
          f"jamba prefill on the card launched {counts}")
    check(f32_used == {"fwd/scalar": 1},
          f"the f32 jamba prefill launched {f32_used}: the scalar forward "
          "expected")

    # 13. serve jamba at full width and JAMBA_LAYERS layers
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    B, P, G = 4, 1024, 32
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, dev).init_weights(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    reset_global_collector()
    reset_counts()
    tokens, stats = serve.generate(model, prompts, G)
    counts = read_counts()
    used = read_variants()
    tree = GraphFrame.from_events(global_collector().drain()).to_dict()
    dec = {c["name"]: c["metrics"] for c in tree["children"]}[
        "serve/decode_step"]
    want = {"flash_attention_fwd": cfg.n_groups * sum(
        s.mixer == "attn" for s in cfg.pattern), "selective_scan":
        cfg.n_groups * sum(s.mixer == "mamba" for s in cfg.pattern)}
    numbers = {
        "layers": cfg.n_layers, "params": n_params, "batch": B, "prompt": P,
        "gen": G, "init_s": init_s, "prefill_ms": stats["prefill_ms"],
        "decode_ms_min": dec["min"] * 1e3, "decode_ms_max": dec["max"] * 1e3,
        "decode_ms_mean": dec["sum"] / dec["count"] * 1e3,
        "decode_tok_s": stats["decode_tok_s"],
        "peak_memory_bytes": stats["peak_memory_bytes"],
        "prefill_kernel_launches": stats["prefill_kernel_launches"],
        "prefill_launches_by_variant": {
            k: n for k, n in stats["prefill_launches_by_variant"].items() if n},
    }
    del model, prompts
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[13] serve jamba full width, {cfg.n_layers} of {full.n_layers} "
          f"layers, {n_params:,} params (init {init_s:.1f} s), B={B} P={P} "
          f"G={G}: prefill {stats['prefill_ms']:.1f} ms; decode ms a step "
          f"min {numbers['decode_ms_min']:.2f}, mean "
          f"{numbers['decode_ms_mean']:.2f}, max {numbers['decode_ms_max']:.2f}"
          f" over {dec['count']} steps ({stats['decode_tok_s']:.1f} tok/s); "
          f"peak memory {stats['peak_memory_bytes']} B "
          f"({stats['peak_memory_bytes'] / 2**30:.2f} GiB); prefill launches "
          f"{stats['prefill_kernel_launches']} "
          f"{numbers['prefill_launches_by_variant']}, whole run {counts} "
          f"{used}", flush=True)
    check(want == {"flash_attention_fwd": 2, "selective_scan": 14},
          f"expected 2 attention and 14 mamba layers, got {want}")
    check(stats["prefill_kernel_launches"] == want,
          f"prefill launches {stats['prefill_kernel_launches']}, "
          f"expected {want}")
    check(counts == {**want, "flash_attention_bwd_dq": 0,
                     "flash_attention_bwd_dkv": 0},
          f"launches over the serving run {counts}: decode must launch "
          f"neither kernel, and serving no backward kernel")
    check(numbers["prefill_launches_by_variant"] == used
          == {"fwd/wgmma": want["flash_attention_fwd"]},
          f"jamba prefill launched {numbers['prefill_launches_by_variant']} "
          f"(whole run {used}): every forward on the wgmma variant expected")
    check(stats["logits_finite"], "non-finite jamba serve logits")
    check(tuple(tokens.shape) == (B, G + 1), f"tokens {tuple(tokens.shape)}")
    check(0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size,
          "generated token out of range")
    return counts, numbers


def card_info():
    """(device name, device count, the card line of nvidia-smi, SM count,
    top SM clock in Hz)."""
    import torch

    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    clock_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return kind, count, card, sms, clock_hz


def scan_sass(lib) -> str:
    """Count, in the SASS of every scan kernel in library ``lib``
    (``cuobjdump -sass``), the special-function (MUFU) instructions and
    the MUFU.EX2 among them; fail unless each kernel's are all EX2 and a
    multiple of four: one a state, four states a lane and a step."""
    import re

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0]
        elif fn and "MUFU" in line:
            counts[fn][0] += 1
            counts[fn][1] += "MUFU.EX2" in line
    check(bool(counts), "no kernel in the scan library's SASS")
    ok = all(mufu == ex2 and ex2 % 4 == 0 and ex2 > 0
             for mufu, ex2 in counts.values())
    summary = sorted({f"{mufu} MUFU, {ex2} MUFU.EX2"
                      for mufu, ex2 in counts.values()})
    print(f"    scan SASS, {len(counts)} kernels: {'; '.join(summary)} a "
          f"kernel (four EX2 a step body: one a state)", flush=True)
    check(ok, f"scan SASS: a MUFU other than EX2, or EX2 not four a step: "
          f"{counts}")
    return "; ".join(summary)


def build_phase() -> dict:
    """Phase 2: build every kernel, one nvcc per source, all started
    together, and print what ptxas says of each instantiation, the shared
    memory and blocks an SM of the wgmma kernels and of the scan, and the
    scan's special-function instructions (:func:`scan_sass`). Returns
    {instantiation: report}."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel

    t0 = time.perf_counter()
    libs = build.build()
    build_s = time.perf_counter() - t0
    print(f"[2] built {', '.join(p.name for p in libs.values())} "
          f"in {build_s:.1f} s")
    reports = {}
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            for kernel_name, report in ptxas_report(log.read_text()):
                print(f"    ptxas {kernel_name}: {report}")
                reports[kernel_name] = report
    for name in ("fwd", "dq", "dkv"):
        for D in kernel.HEAD_DIMS:
            smem, blocks = kernel.wgmma_info(name, D)
            reports[f"{name} wgmma D={D} smem"] = (
                f"{smem} B dynamic shared memory, {blocks} blocks an SM")
            print(f"    {name} wgmma D={D}: {smem} B dynamic shared memory, "
                  f"{blocks} blocks an SM", flush=True)
    for x_dt, p_dt in ((torch.bfloat16, torch.float32),
                       (torch.float32, torch.float32),
                       (torch.bfloat16, torch.bfloat16)):
        for N in scan_kernel.STATE_SIZES:
            smem, blocks = scan_kernel.selective_scan_info(N, x_dt, p_dt)
            label = (f"scan x {str(x_dt)[6:]}, dt/B/C {str(p_dt)[6:]}, "
                     f"N={N}")
            reports[f"{label} smem"] = (
                f"{smem} B dynamic shared memory, {blocks} blocks an SM")
            print(f"    {label}: {smem} B dynamic shared memory, {blocks} "
                  f"blocks an SM", flush=True)
    reports["scan sass"] = scan_sass(libs["selective_scan"])
    return reports


def setup():
    """Fail unless a card is present and the port is beside this script;
    put the port on the path and keep f32 products in f32."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main() -> None:
    import torch

    setup()
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_decode_step, make_prefill_step

    dev = torch.device("cuda")

    # 1. the card
    kind, count, card, sms, clock_hz = card_info()
    print(f"[1] device: {kind} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {sms} SMs, top SM clock "
          f"{clock_hz / 1e6:.0f} MHz")
    print(card, flush=True)

    # 2. build, one nvcc per source, all started together
    reports = build_phase()

    # 3. one wgmma product against torch.matmul, then the kernel against
    # its plain version on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    for D in kernel.HEAD_DIMS:
        a, b, v = (torch.randn(64, D, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(3))
        c1, c2 = kernel.wgmma_probe(a, b, v)
        torch.cuda.synchronize()
        want1 = torch.matmul(a.float(), b.float().T)
        want2 = torch.matmul(c1.to(torch.bfloat16).float(), v.float())
        r1, r2 = rel_err(c1, want1), rel_err(c2, want2)
        print(f"[3] wgmma m64n64k16 x {D // 16} (K-major A, B) and m64n{D}k16"
              f" x 4 (register A, MN-major B) against torch.matmul: "
              f"max|err|/max|ref| {r1:.3e} / {r2:.3e} (< 1e-4)", flush=True)
        check(r1 < 1e-4 and r2 < 1e-4, f"wgmma product disagrees at D={D}")

    def qkv(B, T, H, K, D, dtype, S=None):
        dt = getattr(torch, dtype)
        S = T if S is None else S
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D))]

    serving = dict(B=4, T=1024, H=32, K=4, D=128, dtype="bfloat16",
                   causal=True, window=None)
    cases = [
        ("serving", serving),
        ("ragged T=1000", dict(serving, T=1000)),
        ("window=256", dict(serving, window=256)),
        ("non-causal", dict(serving, causal=False)),
        # the jamba prefill's attention layers: 8 kv heads, G = 4
        ("jamba K=8", dict(serving, K=8)),
        ("f32 D=64", dict(B=2, T=512, H=8, K=2, D=64, dtype="float32",
                          causal=True, window=None)),
        *SMALL_BF16_CASES,
    ]
    errs = {}
    for label, c in cases:
        q, k, v = qkv(c["B"], c["T"], c["H"], c["K"], c["D"], c["dtype"],
                      c.get("S"))
        reset_counts()
        out, lse = ops.flash_attention(q, k, v, causal=c["causal"],
                                       window=c["window"])
        torch.cuda.synchronize()
        used = read_variants()
        r_out, r_lse = ref.flash_attention_ref(q, k, v, causal=c["causal"],
                                               window=c["window"])
        err = (out.float() - r_out.float()).abs()
        e_out = float(err.max())
        at_worst = float(r_out.float().flatten()[err.argmax()].abs())
        e_lse = float((lse - r_lse).abs().max())
        ok = (e_out < OUT_TOL[c["dtype"]] and e_lse < LSE_TOL
              and used == variants_of({("fwd", c["dtype"]): 1}))
        errs[label] = (e_out, e_lse)
        print(f"[3] {label:27s} out max|err| {e_out:.3e} "
              f"(< {OUT_TOL[c['dtype']]:g}; |ref out| there {at_worst:.3g})"
              f", lse {e_lse:.3e} (< {LSE_TOL:g})"
              f"; {used} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"kernel disagrees with its plain version: {label}")
        del q, k, v, out, lse, r_out, r_lse, err

    # 4. timing at the serving shape
    s = serving
    q, k, v = qkv(s["B"], s["T"], s["H"], s["K"], s["D"], s["dtype"])
    k_ms = cuda_ms(lambda: kernel.flash_fwd(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(
        s["B"], s["T"], s["T"], s["H"], s["K"], s["D"], True, None, 2,
        PEAK_BF16_FLOPS)
    k2_ms = cuda_ms(lambda: kernel.flash_fwd(q, k, v, causal=True))
    del q, k, v, qt, kt, vt
    print(f"[4] serving shape: kernel {k_ms:.3f} / {k2_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB), "
          f"kernel at {bound_ms / k_ms:.2%} of bound", flush=True)

    # 5a. the whole model on the card against the same model on the CPU
    cfg = dataclasses.replace(get_config("yi-6b", "full"), n_layers=2,
                              dtype="float32")
    cpu = torch.device("cpu")
    m_gpu = Model(cfg, dev).init_weights(0)
    m_cpu = Model(cfg, cpu)
    m_cpu.load_state_dict(m_gpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(0))
    worst = 0.0
    reset_counts()
    with torch.no_grad():
        results = []
        for m, d in ((m_gpu, dev), (m_cpu, cpu)):
            caches = m.alloc_cache(2, 103)
            logits = [make_prefill_step(cfg)(m, {"tokens": toks[:, :97].to(d)},
                                             caches)]
            for t in range(97, 100):
                logits.append(make_decode_step(cfg)(
                    m, caches, {"tokens": toks[:, t:t + 1].to(d)}, t)[0])
            results.append([x.cpu() for x in logits])
        for a, b in zip(*results):
            check(bool(torch.isfinite(a).all()), "non-finite model logits")
            worst = max(worst, float((a - b).abs().max()))
    del m_gpu, m_cpu
    torch.cuda.empty_cache()
    f32_used = read_variants()
    print(f"[5] yi-6b width, 2 layers, f32: card vs CPU logits max|err| "
          f"{worst:.3e} (< {MODEL_TOL:g}) over prefill + 3 decode steps; "
          f"card launches {f32_used}")
    check(worst < MODEL_TOL, "model on the card disagrees with the CPU")
    check(f32_used == {"fwd/scalar": cfg.n_layers},
          f"the f32 prefill launched {f32_used}: the scalar forward expected")

    # 5b. serve yi-6b at full width: the serving path
    B, P, G = 4, 1024, 32
    reset_counts()
    tokens, stats = serve.main(["--arch", "yi-6b", "--preset", "full",
                                "--batch", str(B), "--prompt-len", str(P),
                                "--gen", str(G), "--seed", "0"])
    serve_counts = read_counts()
    serve_used = read_variants()
    launches = serve_counts["flash_attention_fwd"]
    full = get_config("yi-6b", "full")
    steps = {c["name"]: c["metrics"] for c in stats["tree"]["children"]}
    dec = steps["serve/decode_step"]
    print(f"[5] decode step ms: min {dec['min'] * 1e3:.2f}, max "
          f"{dec['max'] * 1e3:.2f}, mean {dec['sum'] / dec['count'] * 1e3:.2f}"
          f" over {dec['count']} steps")
    print(f"[5] serve: prefill {stats['prefill_ms']:.1f} ms, decode "
          f"{stats['decode_tok_s']:.1f} tok/s, peak memory "
          f"{stats['peak_memory_bytes']} B, kernel launches {launches} "
          f"({serve_used})", flush=True)
    check(launches == full.n_layers
          == stats["prefill_kernel_launches"]["flash_attention_fwd"],
          f"expected {full.n_layers} kernel launches in one prefill, "
          f"got {launches}")
    check(serve_counts["flash_attention_bwd_dq"]
          == serve_counts["flash_attention_bwd_dkv"]
          == serve_counts["selective_scan"] == 0,
          f"backward or scan kernels launched while serving yi-6b: "
          f"{serve_counts}")
    prefill_used = {k: n for k, n in
                    stats["prefill_launches_by_variant"].items() if n}
    check(prefill_used == serve_used == {"fwd/wgmma": full.n_layers},
          f"yi-6b prefill launched {prefill_used} (whole run {serve_used}): "
          "every forward on the wgmma variant expected")
    check(stats["logits_finite"], "non-finite serve logits")
    check(tuple(tokens.shape) == (B, G + 1), f"tokens {tuple(tokens.shape)}")
    check(0 <= int(tokens.min()) and int(tokens.max()) < full.vocab_size,
          "generated token out of range")

    bwd = backward_phases(qkv)
    train_counts, train_stats = train_phases()
    scan = scan_phases(sms, clock_hz)
    jamba_counts, jamba = jamba_phases()

    # 14. result lines
    paths = {"serve": serve_counts, "train": train_counts,
             "serve_jamba": jamba_counts}

    def launches_of(name):
        by_path = {p: c[name] for p, c in paths.items()}
        return sum(by_path.values()), by_path

    shape = "B=4 T=1024 H=32 K=4 D=128 bf16 causal"
    fwd_total, fwd_paths = launches_of("flash_attention_fwd")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "design": DESIGN["flash_attention_fwd"],
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": fwd_total,
        "launches_by_path": fwd_paths,
        "max_abs_err": errs["serving"][0],
        "lse_max_abs_err": errs["serving"][1],
        "ms": k_ms,
        "ms_again": k2_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
        "ptxas": reports.get("flash_fwd_wgmma_kernel<128>"),
        "smem": reports.get("fwd wgmma D=128 smem"),
        "shape": shape,
        "card": card,
    }]
    for part, replaces in (("dq", TPU_DQ), ("dkv", TPU_DKV)):
        total, by_path = launches_of(f"flash_attention_bwd_{part}")
        t = bwd["timing"][part]
        name = f"flash_attention_bwd_{part}"
        kernels.append({
            "name": name,
            "route": "cuda",
            "design": DESIGN[name],
            "source": BWD_SOURCE,
            "replaces": replaces,
            "launches": total,
            "launches_by_path": by_path,
            "max_abs_err": bwd["abs_err"][part],
            "rel_err": bwd["rel_err"][part],
            "ms": t["ms"],
            "ms_again": t["ms_again"],
            "plain_ms": bwd["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": bwd["library_ms"],
            "ptxas": reports.get(f"flash_bwd_{part}_wgmma_kernel<128>"),
            "smem": reports.get(f"{part} wgmma D=128 smem"),
            "shape": shape,
            "card": card,
        })
    total, by_path = launches_of("selective_scan")
    t = scan["timing"]
    kernels.append({
        "name": "selective_scan",
        "route": "cuda",
        "design": DESIGN["selective_scan"],
        "source": SCAN_SOURCE,
        "replaces": TPU_SCAN,
        "launches": total,
        "launches_by_path": by_path,
        "max_abs_err": scan["serving"]["y"],
        "rel_err": scan["serving"]["y_rel"],
        "err_beyond_rounding": scan["serving"]["y_beyond_rounding"],
        "state_max_abs_err": scan["serving"]["state"],
        "ms": t["ms"],
        "ms_again": t["ms_again"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "ptxas": reports.get("selective_scan_kernel<x bf16, dt/B/C f32, "
                             "N=16>"),
        "smem": reports.get("scan x bfloat16, dt/B/C float32, N=16 smem"),
        "sass": reports.get("scan sass"),
        "shape": "B=4 T=1024 dI=8192 N=16 x bf16 dt/B/C f32",
        "card": card,
    })
    print(json.dumps({"kernels": kernels,
                      "train": {k: train_stats[k] for k in (
                          "layers", "params", "step_ms", "mean_step_ms",
                          "tokens_per_s", "peak_memory_bytes")},
                      "serve_jamba": jamba}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        fail("unhandled exception")
