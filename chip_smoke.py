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
     and G = H/K of 1 and 8, and head dim 16 in bf16 and f32 (the
     default commands' shape among them); every bf16 case must launch the
     wgmma variant and every f32 case the scalar one;
  4. time the forward kernel, its plain version and PyTorch's
     scaled_dot_product_attention (yardstick only) at the serving shape,
     with CUDA events, turn about; compute the least time the card could
     take;
  5. the port's model on the card against the same model on the CPU at
     full yi-6b width, two layers, f32 (scalar kernels); then serve yi-6b
     at full width through ``repro_torch.launch.serve.main`` (batch 4,
     prompt 1024, 32 generated tokens) and check that every prefill
     attention went through the wgmma forward;
 5c. the bf16 forward on yi-6b's own q, k and v of every layer (a
     prefill of its own, of the same model and prompts, outside the
     serving path's counts and memory) against the f32 plain version: the
     largest error must stay under the reference's bf16 bound;
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
 15. the default commands on the card (``launch.serve`` for yi-6b and for
     jamba, ``launch.train``; the smoke preset: bf16, head dim 16), each
     held to the same call with ``--device cpu``: the prefill logits, the
     first tokens where no near tie decides them, the train losses, and
     every attention on the wgmma D = 16 variants;
 16. time the D = 16 forward, dq and dk/dv at the default training shape,
     beside their plain versions and scaled_dot_product_attention;
 17. the COMB-style halo app (``launch.halo``) under all four comm
     backends at box 128 a rank on 8 ranks: explicit against vendor
     output, the card against the CPU at box 16 (output, checksum, fabric
     counters), wall ms a run, and the Figure 2/3 comparison trees;
 18. device traces of the main paths, each one profiled call with its
     model alive (inside phases 5c, 9 and 13): a yi-6b train step, a yi-6b
     prefill and decode step, a jamba prefill; for each the card's busy
     and idle share, the top kernels, the longest idle gaps and the host
     span open in each, the roofline of the counted FLOPs and bytes, the
     model FLOPs and the MFU; every hand-written kernel the call launched
     must be in the trace under its symbol as often as its wrapper
     counted, and a trace without a kernel fails the run;
 19. the halo app's device timeline (inside phase 17): each backend's
     serialization report from one profiled run, the explicit backends'
     collective lane on the progress engine's stream; then one
     explicit_overlap run recorded (``repro_torch.trace``) and replayed
     under both queue disciplines against the record-time counters;
 20. (run right after phase 5, before any profiler) serve yi-6b again as
     in phase 5 (full width, 32 layers, bf16, the same seed and
     requests) with ``--telemetry`` while a client thread reads
     ``/metrics`` and ``/findings`` during decode and one frame of
     ``/stream``: the same tokens as phase 5, 32 wgmma forwards in the
     prefill, the bridge's polls and its no-loss accounting over the
     global counter registry (seeded with a host-side leaky-UMQ storm),
     and every serving region in the watched collector; then the same
     requests with the bridge alone and with no telemetry, and decode ms
     a step of the four serves in turns; then the host packages on this
     machine: live progress records under both disciplines, the smoke
     scenario sweep against its committed baseline, the committed trace
     corpus through a spawn pool of two;
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
# the default commands (bf16 smoke preset) card vs CPU: prefill logits as
# max|err| / max|ref| (the kernels' bf16 bound; one bf16 ulp at the
# logits' |0.6| is 2^-9), train losses absolute (f32 losses of bf16
# compute, ~5.5)
DEFAULT_LOGITS_TOL = 2e-2
DEFAULT_LOSS_TOL = 1e-3
HALO_BOX = 128       # per rank; 8 ranks: a 256^3 f32 field of 64 MiB
HALO_TOL = 1e-5      # f32 stencil sums, explicit vs vendor, card vs CPU
# each kernel's design on the bf16 main paths
DESIGN = {"flash_attention_fwd": "wgmma", "flash_attention_bwd_dq": "wgmma",
          "flash_attention_bwd_dkv": "wgmma",
          "selective_scan": "states split over lanes, cp.async ring"}
# bf16 edge cases of phases 3 and 6: head dims 32 and 64, lengths shorter
# than a tile and not multiples of it, a window that starts inside a 64-key
# tile, non-causal S != T, and G = H/K of 1 and 8 (K = 2 and 4)
_SMALL = dict(B=2, T=200, H=16, K=2, D=128, dtype="bfloat16", causal=True,
              window=None)
# the attention of the default commands: the smoke preset's 4 heads of
# D = 16 (4 kv heads), at the default training batch (B=8, T=256), bf16
DEFAULT_ATTENTION = dict(B=8, T=256, H=4, K=4, D=16, dtype="bfloat16",
                         causal=True, window=None)
# head dim 16 in bf16 (wgmma, 32-byte swizzle, m64n16k16) and f32 (the
# scalar kernels with half a warp's lanes on the head dim), for phases 3
# and 6
D16_CASES = [
    ("bf16 D=16 default commands", DEFAULT_ATTENTION),
    ("bf16 D=16 T=200 G=8", dict(_SMALL, D=16)),
    ("bf16 D=16 T=1000 window=48", dict(_SMALL, D=16, T=1000, window=48)),
    ("bf16 D=16 T=17 G=1", dict(_SMALL, D=16, T=17, H=2)),
    ("bf16 D=16 T=160 S=300 non-causal", dict(_SMALL, D=16, T=160, S=300,
                                               causal=False)),
    ("f32 D=16 T=200", dict(_SMALL, D=16, dtype="float32")),
    ("f32 D=16 T=17 window=8", dict(_SMALL, D=16, T=17, window=8,
                                     dtype="float32")),
]
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


def least_ms(flops, nbytes, peak):
    """Least time: the larger of the FLOP over the peak rate and the bytes
    over the memory rate. Returns (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bound_ms(B, T, S, H, K, D, causal, window, itemsize, peak):
    """Least time for one forward call, from the FLOPs and bytes that
    ``repro_torch.core.cost.attention_work`` counts (4·D per unmasked
    (q, k) pair per head; q, k, v read once, out and lse written once)."""
    from repro_torch.core.cost import attention_work

    flops, nbytes = attention_work(B, T, S, H, K, D, causal, window, itemsize)
    ms, by = least_ms(flops, nbytes, peak)
    return ms, by, flops, nbytes


def backward_bound_ms(B, T, S, H, K, D, causal, window, itemsize, peak):
    """Least time of each backward kernel, from the FLOPs and bytes that
    ``repro_torch.core.cost.backward_work`` counts (6·D per unmasked pair
    per head for dq, 8·D for dk/dv; q, k, v, do, lse, delta read once, the
    gradients written once). Returns {"dq": (ms, by, flops, bytes),
    "dkv": ...}."""
    from repro_torch.core.cost import backward_work

    out = {}
    for name, (flops, nbytes) in backward_work(
            B, T, S, H, K, D, causal, window, itemsize).items():
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
    """Least time for one scan call, from the work that
    ``repro_torch.core.cost.scan_work`` counts: the bytes (x, dt, B, C, A,
    D read once, y and the final state written once), the f32 FLOPs at
    the f32 peak, and one ex2 per (b, t, d, n) on the SFU, at
    ``SFU_PER_CLOCK_SM`` a clock on each SM at the card's top SM clock.
    Returns (ms, what bounds it, detail)."""
    from repro_torch.core.cost import scan_work

    flops, exps, nbytes = scan_work(B, T, dI, N, x_item, p_item)
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
        *D16_CASES,
    ]

    def inputs(c):
        q, k, v = qkv(c["B"], c["T"], c["H"], c["K"], c["D"], c["dtype"],
                      c.get("S"))
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        out, lse = ref.flash_attention_ref(q, k, v, causal=c["causal"],
                                           window=c["window"])
        return q, k, v, out, lse, do

    result = {"abs_err": {}, "rel_err": {}, "errs": {}}
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
        result["errs"][label] = {"dq": abss[0], "dkv": max(abss[1:]),
                                 "dq_rel": rels[0], "dkv_rel": max(rels[1:])}
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
    training path at the slice's size; phase 18: a profiled step. Returns
    (launch counts of the training path, its stats, the traced step)."""
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

    # 18. one profiled step of the same model and shape (train.main frees
    # its model when it returns: a model of the same seed takes its place)
    import gc

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("yi-6b", "full"), n_layers=L)
    model = Model(cfg, dev, trainable=True).init_weights(0)
    opt_state = adamw.init_state(dict(model.named_parameters()))
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in
             SyntheticTokens(cfg, DataConfig(batch=B, seq_len=T)
                             ).batch_at(0).items()}
    step = make_train_step(cfg, adamw.AdamWConfig())
    traced = traced_call(f"yi-6b train step ({L} layers, B={B} T={T})",
                         lambda: step(model, opt_state, batch), cfg,
                         ShapeConfig("train", T, B, "train"),
                         phases=TRAIN_PHASES)
    del model, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts, stats, traced


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
    serve jamba at the slice's size, then (phase 18) one profiled
    prefill. Returns (launch counts of the serving path, its numbers)."""
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

    # 18. one profiled prefill of the served model
    from repro_torch.configs.base import ShapeConfig

    caches = model.alloc_cache(B, P)
    prefill = make_prefill_step(cfg)
    with torch.no_grad():
        numbers["trace"] = traced_call(
            f"jamba prefill ({cfg.n_layers} layers, B={B} P={P})",
            lambda: prefill(model, {"tokens": prompts}, caches), cfg,
            ShapeConfig("prefill", P, B, "prefill"))
    del model, prompts, caches
    gc.collect()
    torch.cuda.empty_cache()
    return counts, numbers


def default_commands_phase():
    """Phase 15: ``python -m repro_torch.launch.serve`` (yi-6b and jamba)
    and ``python -m repro_torch.launch.train`` with their default
    arguments (the smoke preset: bf16, head dim 16) on the card, each held
    to the same call with ``--device cpu``. Returns {path: launch counts}."""
    import math

    from repro_torch.configs.archs import get_config
    from repro_torch.launch import serve, train

    counts = {}
    for path, argv in (("serve_default", []),
                       ("serve_jamba_default", ["--arch", "jamba-v0.1-52b"])):
        cfg = get_config(argv[1] if argv else "yi-6b", "smoke")
        n_attn = cfg.n_groups * sum(s.mixer == "attn" for s in cfg.pattern)
        n_mamba = cfg.n_groups * sum(s.mixer == "mamba" for s in cfg.pattern)
        reset_counts()
        tokens, stats = serve.main(argv)
        counts[path] = read_counts()
        used = read_variants()
        cpu_tokens, cpu_stats = serve.main(argv + ["--device", "cpu"])
        got, want = stats["prefill_logits"], cpu_stats["prefill_logits"]
        err = rel_err(got, want)
        top2 = want.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        clear = margin > 2 * float((got - want).abs().max())
        first_ok = bool((tokens[:, :1].cpu() == cpu_tokens[:, :1])[clear].all())
        same = float((tokens.cpu() == cpu_tokens).float().mean())
        print(f"[15] {path}: {cfg.name} smoke (D={cfg.head_dim}, "
              f"{cfg.dtype}): prefill logits card vs CPU max|err|/max|ref| "
              f"{err:.3e} (< {DEFAULT_LOGITS_TOL:g}); first tokens agree "
              f"where the CPU's top-2 margin exceeds twice the logits' error "
              f"({int(clear.sum())} of {clear.numel()}): {first_ok}; all "
              f"tokens equal {same:.3f}; launches {counts[path]} {used}",
              flush=True)
        check(err < DEFAULT_LOGITS_TOL,
              f"{path}: prefill logits on the card disagree with the CPU")
        check(first_ok, f"{path}: a clear first token differs from the CPU's")
        check(stats["logits_finite"], f"{path}: non-finite logits")
        check(used == {"fwd/wgmma": n_attn},
              f"{path} launched {used}: {n_attn} bf16 D=16 forwards on the "
              "wgmma variant expected")
        check(counts[path]["selective_scan"] == n_mamba,
              f"{path}: {counts[path]['selective_scan']} scans, expected "
              f"{n_mamba}")

    reset_counts()
    losses, stats = train.main([])
    counts["train_default"] = read_counts()
    cpu_losses, _ = train.main(["--device", "cpu"])
    diff = max(abs(a - b) for a, b in zip(losses, cpu_losses))
    L = stats["layers"]
    per_step = variants_of({("fwd", "bfloat16"): 2 * L, ("dq", "bfloat16"): L,
                            ("dkv", "bfloat16"): L})
    print(f"[15] train_default: yi-6b smoke, {len(losses)} steps: losses "
          f"card vs CPU max|diff| {diff:.3e} (< {DEFAULT_LOSS_TOL:g}); first "
          f"{losses[0]:.5f} / {cpu_losses[0]:.5f}, last {losses[-1]:.5f} / "
          f"{cpu_losses[-1]:.5f}; launches {counts['train_default']}, each "
          f"step {per_step}", flush=True)
    check(len(losses) == len(cpu_losses) and all(
        math.isfinite(x) for x in losses), "train_default: bad losses")
    check(diff < DEFAULT_LOSS_TOL,
          "train_default: losses on the card disagree with the CPU")
    check(all({k: n for k, n in s.items() if n} == per_step
              for s in stats["launches_by_variant"]),
          f"train_default launches by variant {stats['launches_by_variant']}"
          f", expected {per_step} a step")
    return counts


def d16_timing_phase(qkv) -> dict:
    """Phase 16: the D = 16 forward, dq and dk/dv at the default commands'
    training shape (``DEFAULT_ATTENTION``), with CUDA events, turn about
    with their plain versions and scaled_dot_product_attention (yardstick
    only); compute the least time the card could take."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ref

    c = DEFAULT_ATTENTION
    q, k, v = qkv(c["B"], c["T"], c["H"], c["K"], c["D"], c["dtype"])
    do = torch.randn_like(q)
    out, lse = kernel.flash_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    runs = {"fwd": lambda: kernel.flash_fwd(q, k, v),
            "dq": lambda: kernel.flash_bwd_dq(q, k, v, do, lse, delta),
            "dkv": lambda: kernel.flash_bwd_dkv(q, k, v, do, lse, delta)}
    ms = {name: cuda_ms(fn, iters=50) for name, fn in runs.items()}
    plain = {"fwd": cuda_ms(lambda: ref.flash_attention_ref(q, k, v)),
             "bwd": cuda_ms(lambda: ref.flash_attention_bwd_ref(
                 q, k, v, out, lse, do), iters=5)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lib = {"fwd": cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                          iters=50)}
    ot = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    lib["bwd"] = cuda_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), iters=50)
    again = {name: cuda_ms(fn, iters=50) for name, fn in runs.items()}
    shape = (c["B"], c["T"], c["T"], c["H"], c["K"], c["D"], True, None, 2,
             PEAK_BF16_FLOPS)
    fb_ms, fb_by, f_flops, f_bytes = attention_bound_ms(*shape)
    bounds = {"fwd": (fb_ms, fb_by, f_flops, f_bytes),
              **backward_bound_ms(*shape)}
    result = {}
    for name in ("fwd", "dq", "dkv"):
        b_ms, b_by, flops, nbytes = bounds[name]
        result[name] = {
            "ms": ms[name], "ms_again": again[name], "bound_ms": b_ms,
            "bound_by": b_by,
            "plain_ms": plain["fwd" if name == "fwd" else "bwd"],
            "library_ms": lib["fwd" if name == "fwd" else "bwd"]}
        print(f"[16] D=16 {name} (B={c['B']} T={c['T']} H={c['H']} "
              f"K={c['K']} bf16 causal): kernel {ms[name]:.4f} / "
              f"{again[name]:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
              f"{flops:.3e} FLOP, {nbytes / 1e6:.2f} MB), kernel at "
              f"{b_ms / ms[name]:.2%} of bound", flush=True)
    print(f"[16] D=16 plain forward {plain['fwd']:.4f} ms, plain backward "
          f"(dq, dk, dv) {plain['bwd']:.4f} ms; sdpa forward "
          f"{lib['fwd']:.4f} ms, backward {lib['bwd']:.4f} ms", flush=True)
    return result


# the symbol of each hand-written kernel in a device trace, by the
# launch count that counts it (flash: launches_by_variant's keys)
SYMBOLS = {"fwd/wgmma": "flash_fwd_wgmma_kernel",
           "fwd/scalar": "flash_fwd_f32_kernel",
           "dq/wgmma": "flash_bwd_dq_wgmma_kernel",
           "dq/scalar": "flash_bwd_dq_f32_kernel",
           "dkv/wgmma": "flash_bwd_dkv_wgmma_kernel",
           "dkv/scalar": "flash_bwd_dkv_f32_kernel",
           "selective_scan": "selective_scan_kernel"}
TRAIN_PHASES = ("train/forward", "train/backward", "train/update",
                "model/layer")


def traced_call(label: str, fn, cfg, shape, phases=()) -> dict:
    """Phase 18: one call of ``fn`` (a step of a main path, its model
    alive), after a warm-up call, three times: timed on the host clock to
    its end, profiled (``repro_torch.core.device_timeline.profile``), and
    counted (``repro_torch.core.cost.count_cost``). Prints the card's busy
    and idle share, the top 10 kernels, the 5 longest idle gaps with the
    host span open in each, and the roofline of the counted work against
    ``launch.flops.model_flops(cfg, shape)`` with the MFU of the timed
    call. Fails unless every hand-written kernel the call launched is in
    the trace under its symbol as often as its wrapper counted it."""
    import torch

    from repro_torch.core import cost, device_timeline
    from repro_torch.core.roofline import HW, Roofline
    from repro_torch.kernels.mamba_scan.ops import selective_scan
    from repro_torch.launch.flops import model_flops

    check(HW["peak_flops_bf16"] == PEAK_BF16_FLOPS
          and HW["hbm_bw"] == PEAK_BYTES,
          f"roofline.HW {HW} differs from this script's peaks")
    phase_t0 = time.perf_counter()
    fn()                                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    _, trace = device_timeline.profile(fn)
    profiled_s = time.perf_counter() - t0
    counted = dict(read_variants())
    if selective_scan.launches:
        counted["selective_scan"] = selective_scan.launches
    seen = device_timeline.launches_by_symbol(trace, list(SYMBOLS.values()))
    want = {SYMBOLS[k]: counted.get(k, 0) for k in SYMBOLS}
    _, tally = cost.step_cost(fn)
    torch.cuda.synchronize()
    rep = device_timeline.device_report(trace, phases=phases)
    mf = model_flops(cfg, shape)
    roof = Roofline(flops=tally.flops, hbm_bytes=tally.bytes, wire_bytes=0,
                    n_chips=1, model_flops=mf)
    step_mfu = mf / (wall_s * PEAK_BF16_FLOPS)     # model FLOPs utilization
    print(f"[18] {label}: wall {wall_s * 1e3:.2f} ms unprofiled, "
          f"{profiled_s * 1e3:.2f} ms profiled (the trace written and read "
          f"included); card window "
          f"{rep['window_ms']:.2f} ms, busy {rep['busy_ms']:.2f} ms: busy "
          f"share {rep['busy_share']:.4f}, idle share "
          f"{rep['idle_share']:.4f}; {rep['events']} events on streams "
          f"{ {k: round(v['ms'], 3) for k, v in rep['streams'].items()} }",
          flush=True)
    for k in rep["kernels"]:
        print(f"[18]   kernel {k['ms']:9.3f} ms {k['launches']:5d}x  "
              f"{k['name'][:110]}", flush=True)
    for g in rep["idle_gaps"]:
        print(f"[18]   idle {g['ms']:8.3f} ms at {g['at_ms']:9.3f} ms, host "
              f"in {' < '.join(g['host_path']) or '(no span)'}", flush=True)
    for key, row in sorted(rep["by_phase"].items()):
        print(f"[18]   phase {key or '(none)'}: "
              f"{ {c: round(ms, 3) for c, ms in sorted(row.items())} } ms",
              flush=True)
    ops = {k: f"{v:.3e}" for k, v in tally.flops_by_op.items()}
    ops.update({k: f"{v['flops']:.3e}" for k, v in tally.kernels.items()})
    print(f"[18]   roofline: {roof.summary()}; counted {tally.flops:.4e} "
          f"FLOP ({ops}), {tally.bytes:.4e} B (upper estimate); model "
          f"{mf:.4e} FLOP; "
          f"useful-flops share {roof.useful_flops_fraction:.4f}; MFU "
          f"{step_mfu:.4f} (model FLOP / ({wall_s * 1e3:.2f} ms x "
          f"{PEAK_BF16_FLOPS:.3g} FLOP/s))", flush=True)
    print(f"[18]   hand-written kernels in the trace {seen}, counted by "
          f"the wrappers {counted}", flush=True)
    check(seen == want, f"{label}: the trace shows {seen}, the wrappers "
          f"counted {want}")
    phase_s = time.perf_counter() - phase_t0
    print(f"[18]   {label}: the four calls took {phase_s:.1f} s", flush=True)
    return {"wall_ms": wall_s * 1e3, "profiled_wall_ms": profiled_s * 1e3,
            "window_ms": rep["window_ms"], "busy_ms": rep["busy_ms"],
            "idle_share": rep["idle_share"], "phase_s": phase_s,
            "kernels": [dict(k, name=k["name"][:100])
                        for k in rep["kernels"]],
            "idle_gaps": rep["idle_gaps"], "by_phase": rep["by_phase"],
            "counted_flops": tally.flops, "counted_bytes": tally.bytes,
            "model_flops": mf, "useful_flops_fraction":
            roof.useful_flops_fraction, "mfu": step_mfu,
            "launches_in_trace": seen}


HALO_BACKENDS = ("xla_auto", "explicit_serial", "explicit_overlap",
                 "explicit_serial_oversub")


def halo_phase():
    """Phase 17: the COMB-style halo app (``repro_torch.launch.halo``)
    under all four comm backends at box 128 per rank on 8 ranks (a
    2 x 2 x 2 mesh: a 256^3 f32 field), 4 steps, 5 timed runs; explicit
    against vendor output; the card against the CPU at box 16 (output,
    checksum, fabric counters); median wall ms per backend; the Figure 2/3
    comparison trees against xla_auto. Returns (launch counts, numbers)."""
    import statistics

    import torch

    from repro_torch.core.comparison import compare_frames
    from repro_torch.core.graphframe import GraphFrame
    from repro_torch.launch import halo as halo_app

    box, steps, runs = HALO_BOX, 4, 5
    outs, frames, numbers = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for be in HALO_BACKENDS:
        payload, out = halo_app.run(be, box=box, steps=steps, runs=runs,
                                    device="cuda", emit_device_timeline=True)
        outs[be] = out
        numbers[be] = {"device_timeline": halo_timeline(be, payload)}
        frames[be] = [GraphFrame.from_dict(f) for f in payload["frames"]]
        walls = [w * 1e3 for w in payload["walls"]]
        numbers[be].update({"median_ms": statistics.median(walls),
                       "min_ms": min(walls), "max_ms": max(walls),
                       "walls_ms": walls, "checksum": payload["checksum"]})
        check(payload["device"] == torch.cuda.get_device_name(0),
              f"halo {be} ran on {payload['device']}")
        check(bool(torch.isfinite(out).all())
              and tuple(out.shape) == (2, 2, 2, box, box, box),
              f"halo {be}: output {tuple(out.shape)} or not finite")
        # where a run's time goes: each COMB segment's mean over the runs,
        # summed over the cycles
        agg = GraphFrame.aggregate(frames[be], metric="sum", how="mean")
        segments = {}
        for path, node in agg.walk():
            if len(path) == 3 and path[0].startswith("cycle_"):
                segments[path[2]] = (segments.get(path[2], 0.0)
                                     + node.metric("value") * 1e3)
        numbers[be]["segments_ms"] = segments
        print(f"[17] halo {be}: box {box}^3 a rank, 8 ranks, {steps} steps: "
              f"wall ms a run median {numbers[be]['median_ms']:.3f}, min "
              f"{numbers[be]['min_ms']:.3f}, max {numbers[be]['max_ms']:.3f} "
              f"over {runs} runs; checksum {payload['checksum']!r}; "
              f"segment ms a run "
              f"{ {k: round(v, 4) for k, v in sorted(segments.items())} }",
              flush=True)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[17] halo launches {counts} (the stencil is plain PyTorch, no "
          f"kernel of the port); peak memory {peak} B", flush=True)
    check(not any(counts.values()), f"the halo app launched {counts}")
    vendor = outs["xla_auto"]
    for be in HALO_BACKENDS[1:]:
        r = rel_err(outs[be], vendor)
        print(f"[17] {be} vs xla_auto output max|err|/max|ref| {r:.3e} "
              f"(< {HALO_TOL:g})", flush=True)
        check(r < HALO_TOL, f"halo {be} disagrees with the vendor backend")
        numbers[be]["vs_vendor"] = r
    del outs, vendor
    torch.cuda.empty_cache()

    def timeless(counters):
        return {k: v if not k.endswith("_ns") else v["count"]
                for k, v in counters.items()}

    for be in HALO_BACKENDS:
        card, out_c = halo_app.run(be, box=16, steps=steps, runs=1,
                                   device="cuda")
        cpu, out_p = halo_app.run(be, box=16, steps=steps, runs=1,
                                  device="cpu")
        r = rel_err(out_c.cpu(), out_p)
        same = timeless(card["counters"]) == timeless(cpu["counters"])
        c_rel = abs(card["checksum"] - cpu["checksum"]) / cpu["checksum"]
        print(f"[17] {be} box 16, card vs CPU: output {r:.3e}, checksum "
              f"{c_rel:.3e} (< {HALO_TOL:g}); fabric counters equal (time "
              f"counters by count): {same}", flush=True)
        check(r < HALO_TOL and c_rel < HALO_TOL,
              f"halo {be} on the card disagrees with the CPU")
        check(same, f"halo {be}: fabric counters differ card vs CPU")

    for fig, be in (("Fig 2 (before the fix)", "explicit_serial_oversub"),
                    ("Fig 3 (after the fix)", "explicit_overlap")):
        cmp = compare_frames(frames["xla_auto"], frames[be],
                             baseline_name="xla_auto", experimental_name=be)
        print(f"[17] {fig}: ratio tree xla_auto / {be} (values < 1: "
              f"{be} slower), box {box}", flush=True)
        print(cmp.tree(fmt="{:.3f}", skip_nan=True), flush=True)
        numbers[be]["hotspots"] = [("/".join(p), v)
                                   for p, v in cmp.hotspots(4)]
        print(f"[17] hotspots: {numbers[be]['hotspots']}", flush=True)
    numbers["peak_memory_bytes"] = peak
    numbers["trace_replay"] = halo_record_replay(box, steps)
    return counts, numbers


def halo_timeline(be: str, payload: dict) -> dict:
    """Phase 19: the serialization report of the halo app's profiled run
    (``--emit-device-timeline``); for an explicit backend, check that the
    collective lane is the progress engine's stream."""
    dt = payload["device_timeline"]
    ser, dev = dt["serialization"], dt["device"]
    print(f"[19] halo {be}: {ser['summary']}; exposed fraction "
          f"{ser['exposed_fraction']:.4f}; card window "
          f"{dev['window_ms']:.3f} ms, idle share {dev['idle_share']:.4f}, "
          f"profiled run {dt['profiled_wall_s'] * 1e3:.3f} ms; side streams "
          f"(the engine's) {dt['engine_streams']}; streams "
          f"{dev['streams']}; collectives {dt['collectives']}", flush=True)
    for g in dev["idle_gaps"]:
        print(f"[19]   idle {g['ms']:8.3f} ms at {g['at_ms']:9.3f} ms, host "
              f"in {' < '.join(g['host_path']) or '(no span)'}", flush=True)
    if be != "xla_auto":
        eng = dt["engine_streams"]
        coll = {s: v["collective_events"] for s, v in dev["streams"].items()
                if v["collective_events"]}
        check(len(eng) == 1 and list(coll) == eng
              and coll[eng[0]] == dev["streams"][eng[0]]["events"]
              and len(dev["streams"]) > 1 and ser["n_collectives"] > 0,
              f"halo {be}: collective events by stream {coll}, side "
              f"streams {eng}: the collective lane must be the engine's one "
              "stream, and only its")
    return {"serialization": ser, "idle_share": dev["idle_share"],
            "window_ms": dev["window_ms"],
            "profiled_wall_ms": dt["profiled_wall_s"] * 1e3,
            "collectives": dt["collectives"]}


def halo_record_replay(box: int, steps: int) -> dict:
    """Phase 19: record one explicit_overlap run (``record_collectives``
    and the progress engine's ``trace=``), replay it under both queue
    disciplines, and hold each replay to the record: no divergent match,
    and every non-time counter of every rank equal to the record-time
    ``snap``."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.comm.halo import HaloProgram
    from repro_torch.comm.mesh import Mesh
    from repro_torch.comm.progress import ProgressEngine
    from repro_torch.core import analyses
    from repro_torch.trace import record_collectives, replay

    t0 = time.perf_counter()
    mesh = Mesh((2, 2, 2), ("x", "y", "z"), device="cuda")
    u = mesh.shard(torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2 * box,) * 3)).to(torch.float32))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "halo.jsonl")
        with record_collectives(path, mode="binned",
                                meta={"backend": "explicit_overlap"}) as fab:
            engine = ProgressEngine("incoming", trace=fab.trace)
            try:
                HaloProgram(mesh, explicit=True).run(u, steps=steps,
                                                     engine=engine)
            finally:
                engine.shutdown()
        size = os.path.getsize(path)
        for disc in ("shared", "incoming"):
            res = replay(path, progress_mode=disc)
            rec = res.recorded_stats
            got = res.totals_by_rank()
            same = {r: {k: (s.count, s.total, s.vmin, s.vmax)
                        for k, s in stats.items() if not k.endswith("_ns")}
                    == {k: (s.count, s.total, s.vmin, s.vmax)
                        for k, s in got.get(r, {}).items()
                        if not k.endswith("_ns")}
                    for r, stats in rec.items()}
            found = analyses.contention(res.progress_events)
            out[disc] = {"ops": len(res.matches),
                         "divergences": len(res.divergences),
                         "phases": len(res.phases), "ranks": len(rec),
                         "lock_events": len(res.progress_events),
                         "contention_findings": len(found)}
            print(f"[19] record explicit_overlap box {box}, {steps} steps "
                  f"({size} B trace), replayed under {disc}: "
                  f"{out[disc]}; non-time counters equal to the record's "
                  f"snap on every rank: {all(same.values())}", flush=True)
            check(rec and not res.divergences and all(same.values()),
                  f"halo trace replay under {disc} disagrees with the "
                  f"record: {len(res.divergences)} divergences, counters "
                  f"equal by rank {same}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[19] record and replays took {out['phase_s']:.1f} s", flush=True)
    return out


def decode_steps(stats) -> dict:
    """The ``serve/decode_step`` metrics (seconds) of a serve run's region
    tree, with ``mean_ms`` added."""
    dec = dict({c["name"]: c["metrics"]
                for c in stats["tree"]["children"]}["serve/decode_step"])
    dec["mean_ms"] = dec["sum"] / dec["count"] * 1e3
    return dec


def _telemetry_client(url: str, stop, log: dict) -> None:
    """Phase 20's HTTP client: wait for the server, read one ``/stream``
    frame, then read ``/metrics`` and ``/findings`` every 50 ms until
    ``stop`` or until the server has gone, logging the host clock
    (``perf_counter_ns``, the clock of the region events) around each
    read."""
    import urllib.error
    import urllib.request

    def get(path):
        with urllib.request.urlopen(url + path, timeout=5) as r:
            return r.read()

    try:
        while not stop.is_set():
            try:
                get("/")
                break
            except urllib.error.URLError:
                time.sleep(0.005)       # the server is not up yet
        with urllib.request.urlopen(url + "/stream", timeout=5) as r:
            buf = b""
            while not log["stream"]:
                chunk = r.read(1)
                if not chunk:
                    break
                buf += chunk
                if buf.endswith(b"\n\n"):
                    if buf.startswith(b"data: "):
                        log["stream"].append(json.loads(buf[6:]))
                    buf = b""
        while not stop.is_set():
            for path in ("/metrics", "/findings"):
                t0 = time.perf_counter_ns()
                try:
                    body = json.loads(get(path))
                except (urllib.error.URLError, ConnectionError):
                    return            # the run ended and its server stopped
                log[path].append((t0, time.perf_counter_ns(), body))
            stop.wait(0.05)
    except Exception as e:            # reported and failed by the phase
        log["errors"].append(repr(e))


def telemetry_phase(B: int, P: int, G: int, want_tokens, want_logits,
                    plain_step_ms: float):
    """Phase 20: serve yi-6b at full width with ``--telemetry`` (the
    arguments and seed of phase 5) while a client thread reads the HTTP
    endpoints; the same requests with the bridge alone and with no
    telemetry (decode ms a step in turns); then the host packages on this
    machine. Returns (launch counts, report)."""
    import random
    import socket
    import threading

    import torch

    from repro_torch import corpus, workloads
    from repro_torch.comm.progress import ProgressEngine
    from repro_torch.configs.archs import get_config
    from repro_torch.core.collector import global_collector
    from repro_torch.core.counters import (global_registry,
                                           reset_global_registry)
    from repro_torch.launch import serve

    full = get_config("yi-6b", "full")
    argv = ["--arch", "yi-6b", "--preset", "full", "--batch", str(B),
            "--prompt-len", str(P), "--gen", str(G), "--seed", "0"]

    def seed_registry():
        # counters that a host-side exchange (the leaky-UMQ storm, smoke
        # size) left pending in the global registry: the bridge's first
        # poll adopts them, so its no-loss accounting and its detectors
        # have work
        reset_global_registry()
        storm = workloads.get("unexpected_storm")
        storm.drive(workloads.build_fabric(storm, "leaky_umq",
                                           registry=global_registry()),
                    random.Random(0), storm.params("smoke"))

    seed_registry()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = {"stream": [], "/metrics": [], "/findings": [], "errors": []}
    stop = threading.Event()
    client = threading.Thread(target=_telemetry_client, daemon=True,
                              args=(f"http://127.0.0.1:{port}", stop, log))
    client.start()
    reset_counts()
    try:
        tokens, stats = serve.main(argv + ["--telemetry", "--telemetry-port",
                                           str(port)])
    finally:
        stop.set()
        client.join(timeout=30)
    counts = read_counts()
    torch.cuda.empty_cache()
    tel = stats["telemetry"]
    drain = global_registry().drain_stats()
    events = global_collector().drain()
    reset_global_registry()
    names = [e.name for e in events]
    decode = [e for e in events if e.name == "serve/decode_step"]
    lo, hi = min(e.t_start for e in decode), max(e.t_end for e in decode)
    during = {path: sum(lo <= t0 and t1 <= hi for t0, t1, _ in log[path])
              for path in ("/metrics", "/findings")}
    dec = decode_steps(stats)
    step_ms = dec["mean_ms"]
    logits_err = float((stats["prefill_logits"] - want_logits).abs().max())
    kinds = sorted({f["kind"] for f in tel["findings"]})
    prefill_used = {k: n for k, n in
                    stats["prefill_launches_by_variant"].items() if n}
    print(f"[20] serve --telemetry: {tel['url']}, {tel['polls']} polls, "
          f"{tel['deltas_total']} deltas (registry merged "
          f"{drain['deltas_merged']}, pending {drain['pending']}), live "
          f"findings {kinds}", flush=True)
    print(f"[20] decode step ms with telemetry {step_ms:.2f} (min "
          f"{dec['min'] * 1e3:.2f}, max {dec['max'] * 1e3:.2f}) beside "
          f"phase 5's {plain_step_ms:.2f}; prefill {stats['prefill_ms']:.1f}"
          f" ms; tokens equal phase 5's: "
          f"{torch.equal(tokens, want_tokens)}; prefill logits max|diff| "
          f"{logits_err:.3e}; prefill launches {prefill_used}", flush=True)
    print(f"[20] client: {len(log['/metrics'])} /metrics and "
          f"{len(log['/findings'])} /findings reads, {during} inside the "
          f"decode window; /stream frames {[f['t'] for f in log['stream']]};"
          f" errors {log['errors']}", flush=True)
    check(torch.equal(tokens, want_tokens),
          "serving with --telemetry changed the tokens of phase 5")
    check(prefill_used == {"fwd/wgmma": full.n_layers}
          and counts["flash_attention_fwd"] == full.n_layers,
          f"telemetry serve launched {prefill_used} ({counts}): "
          f"{full.n_layers} wgmma forwards expected in the prefill")
    check(tel["polls"] >= 1, "the telemetry bridge never polled")
    check(tel["deltas_total"] == drain["deltas_merged"] > 0
          and drain["pending"] == 0,
          f"bridge adopted {tel['deltas_total']} deltas, the registry "
          f"merged {drain['deltas_merged']} ({drain['pending']} pending)")
    check(not log["errors"], f"telemetry client failed: {log['errors']}")
    check(during["/metrics"] >= 1 and during["/findings"] >= 1,
          f"no /metrics or /findings read inside the decode window: {during}")
    check(bool(log["stream"]), "no frame read from /stream")
    check(names.count("serve/prefill") == 1
          and names.count("serve/decode_step") == G,
          f"the regions collector holds {names.count('serve/prefill')} "
          f"prefill and {names.count('serve/decode_step')} decode events")

    # the same requests with the bridge polling the same registry but no
    # client, then with no telemetry: decode ms a step in turns (plain,
    # bridge and client, bridge alone, plain), reported, not gated
    turns = {"plain (phase 5)": plain_step_ms, "bridge and client": step_ms}
    for label, extra in (("bridge alone", ["--telemetry"]),
                         ("plain again", [])):
        seed_registry()
        again, again_stats = serve.main(argv + extra)
        reset_global_registry()
        torch.cuda.empty_cache()
        check(torch.equal(again, want_tokens),
              f"{label}: the tokens differ from phase 5's")
        turns[label] = decode_steps(again_stats)["mean_ms"]
    print(f"[20] decode ms a step in turns: "
          f"{ {k: round(v, 2) for k, v in turns.items()} }", flush=True)

    # the host packages on this machine's Python
    t0 = time.perf_counter()
    live = {}
    for mode in ("shared", "incoming"):
        recs = workloads.live_progress_records(mode)
        evs = [r["ev"] for r in recs]
        live[mode] = {"submit": evs.count("submit"), "proc": evs.count("proc")}
        check(live[mode] == {"submit": workloads.bench.PE_REQUESTS,
                             "proc": workloads.bench.PE_REQUESTS},
              f"live progress records under {mode}: {live[mode]}")
    engine = ProgressEngine(process_fn=lambda _r: None)
    has_stream = engine.stream is not None
    engine.shutdown()
    check(has_stream, "the progress engine made no CUDA stream on the card")
    sweep = workloads.sweep(size="smoke", seed=0)
    with open(os.path.join(HERE, "benchmarks", "baselines",
                           "scenario_baseline_smoke.json")) as f:
        baseline = json.load(f)
    gate = workloads.check(sweep) + workloads.compare_to_baseline(sweep,
                                                                  baseline)
    store = corpus.CorpusStore.load(os.path.join(HERE, "tests", "corpus"))
    with corpus.ReplayPool(jobs=2) as pool:
        run = corpus.run_corpus(store, pool=pool)
    host_s = time.perf_counter() - t0
    print(f"[20] host: live progress records {live}, progress engine stream "
          f"{has_stream}; smoke sweep {len(sweep['scenarios'])} scenarios, "
          f"gate failures {gate}; {run.render().splitlines()[0]} "
          f"(spawn pool of 2); {host_s:.1f} s", flush=True)
    check(not gate, f"smoke sweep against its baseline: {gate}")
    check(run.ok, f"corpus run: {run.failures}")
    return counts, {
        "url": tel["url"], "polls": tel["polls"],
        "deltas_total": tel["deltas_total"],
        "deltas_merged": drain["deltas_merged"], "finding_kinds": kinds,
        "decode_step_ms": step_ms, "decode_step_ms_turns": turns,
        "prefill_ms": stats["prefill_ms"], "prefill_logits_max_diff":
        logits_err, "reads_in_decode": during,
        "stream_frames": len(log["stream"]), "live_progress": live,
        "corpus_entries": len(run.results), "host_s": host_s}


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
        *D16_CASES,
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
    dec = decode_steps(stats)
    print(f"[5] decode step ms: min {dec['min'] * 1e3:.2f}, max "
          f"{dec['max'] * 1e3:.2f}, mean {dec['mean_ms']:.2f}"
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

    # 20. phase 5's requests again with live telemetry (before any
    # profiler has run in this process)
    telemetry_counts, telemetry = telemetry_phase(
        B, P, G, tokens, stats["prefill_logits"], dec["mean_ms"])
    del tokens, stats

    # 5c. the bf16 forward on yi-6b's own prefill activations (q, k, v of
    # each layer at full width, the prompts of 5b) against the f32 plain
    # version; a prefill of its own, outside the serving path's counts
    from repro_torch.models import attention

    captured = []
    flash = attention.flash_attention

    def keep_inputs(q, k, v, causal=True, window=None):
        captured.append((q.clone(), k.clone(), v.clone(), causal, window))
        return flash(q, k, v, causal=causal, window=window)

    model = Model(full, dev).init_weights(0)
    prompts = torch.randint(0, full.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    attention.flash_attention = keep_inputs
    try:
        with torch.no_grad():
            make_prefill_step(full)(model, {"tokens": prompts},
                                    model.alloc_cache(B, P))
    finally:
        attention.flash_attention = flash

    # 18. one profiled prefill and one profiled decode step of this model
    from repro_torch.configs.base import ShapeConfig

    caches = model.alloc_cache(B, P + 1)
    prefill, decode = make_prefill_step(full), make_decode_step(full)
    serve_trace = {}
    with torch.no_grad():
        serve_trace["prefill"] = traced_call(
            f"yi-6b prefill (32 layers, B={B} P={P})",
            lambda: prefill(model, {"tokens": prompts}, caches), full,
            ShapeConfig("prefill", P, B, "prefill"))
        token = prefill(model, {"tokens": prompts}, caches)[:, 0].argmax(
            dim=-1).to(torch.int32)[:, None]
        serve_trace["decode"] = traced_call(
            f"yi-6b decode step (32 layers, B={B}, position {P})",
            lambda: decode(model, caches, {"tokens": token}, P), full,
            ShapeConfig("decode", P, B, "decode"))
    del model, prompts, caches, token
    act = {"max_abs_err": 0.0}
    for layer, (q, k, v, causal, window) in enumerate(captured):
        out, _ = kernel.flash_fwd(q, k, v, causal=causal, window=window)
        want, _ = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                          causal=causal, window=window)
        err = (out.float() - want).abs()
        e = float(err.max())
        if e >= act["max_abs_err"]:
            act = {"max_abs_err": e, "layer": layer,
                   "abs_ref_there": float(want.flatten()[err.argmax()].abs()),
                   "max_abs_ref": float(want.abs().max())}
        del out, want, err
    n_layers = len(captured)
    del captured
    torch.cuda.empty_cache()
    print(f"[5c] bf16 forward on yi-6b's prefill activations (B={B}, "
          f"T={P}, {n_layers} layers) against the f32 plain version: largest "
          f"max|err| {act['max_abs_err']:.4e} at layer {act.get('layer')} "
          f"(|ref| there {act.get('abs_ref_there', 0):.3f}, max|ref| "
          f"{act.get('max_abs_ref', 0):.3f}); bound {OUT_TOL['bfloat16']:g}",
          flush=True)
    check(n_layers == full.n_layers, f"captured {n_layers} prefill layers")
    check(act["max_abs_err"] < OUT_TOL["bfloat16"],
          "the bf16 forward exceeds the reference's bound on the model's "
          "own activations")

    bwd = backward_phases(qkv)
    train_counts, train_stats, train_trace = train_phases()
    scan = scan_phases(sms, clock_hz)
    jamba_counts, jamba = jamba_phases()
    default_counts = default_commands_phase()
    d16 = d16_timing_phase(qkv)
    halo_counts, halo = halo_phase()

    # 14. result lines
    paths = {"serve": serve_counts, "train": train_counts,
             "serve_jamba": jamba_counts, **default_counts,
             "halo": halo_counts, "serve_telemetry": telemetry_counts}

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
    # the head-dim-16 instantiations, on the default commands' paths
    d16_paths = ("serve_default", "serve_jamba_default", "train_default")
    for part, name, replaces, source in (
            ("fwd", "flash_attention_fwd", TPU_KERNEL, KERNEL_SOURCE),
            ("dq", "flash_attention_bwd_dq", TPU_DQ, BWD_SOURCE),
            ("dkv", "flash_attention_bwd_dkv", TPU_DKV, BWD_SOURCE)):
        t = d16[part]
        if part == "fwd":
            err = errs["bf16 D=16 default commands"][0]
        else:
            err = bwd["errs"]["bf16 D=16 default commands"][part]
        kernels.append({
            "name": f"{name}[D=16]",
            "route": "cuda",
            "design": "wgmma, 32-byte swizzle",
            "source": source,
            "replaces": replaces,
            "launches": sum(paths[p][name] for p in d16_paths),
            "launches_by_path": {p: paths[p][name] for p in d16_paths},
            "max_abs_err": err,
            "ms": t["ms"],
            "ms_again": t["ms_again"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "ptxas": reports.get(
                f"{'flash_fwd' if part == 'fwd' else 'flash_bwd_' + part}"
                f"_wgmma_kernel<16>"),
            "smem": reports.get(f"{part} wgmma D=16 smem"),
            "shape": "B=8 T=256 H=4 K=4 D=16 bf16 causal",
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
                      "serve_jamba": jamba,
                      "bf16_forward_on_yi6b_activations": act,
                      "halo": halo,
                      "serve_telemetry": telemetry,
                      "device_traces": {"train": train_trace,
                                        "serve": serve_trace,
                                        "serve_jamba": jamba["trace"]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        fail("unhandled exception")
