#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final line):
  1. the card: name, count, power limit (nvidia-smi);
  2. build the CUDA flash-attention kernels (forward; backward dq and
     dk/dv) from this checkout's sources, one nvcc per source, in parallel;
  3. hold the forward kernel to its plain PyTorch version on the card: the
     yi-6b serving shape (B=4, T=1024, H=32, K=4, D=128, bf16, causal), a
     ragged length, a window, non-causal, and f32 at D=64;
  4. time the forward kernel, its plain version and PyTorch's
     scaled_dot_product_attention (yardstick only) at the serving shape,
     with CUDA events; compute the least time the card could take;
  5. the port's model on the card against the same model on the CPU at
     full yi-6b width, two layers, f32; then serve yi-6b at full width
     through ``repro_torch.launch.serve.main`` (batch 4, prompt 1024,
     32 generated tokens) and check that every prefill attention went
     through the kernel;
  6. hold the dq and dk/dv kernels to the plain backward on the card: the
     yi-6b training shape (the serving shape above), a ragged length, a
     window, non-causal, and f32 at D=64;
  7. time both backward kernels, the plain backward and the backward of
     scaled_dot_product_attention (yardstick only) at the training shape;
  8. one train step of the port on the card against the same step on the
     CPU at full yi-6b width, two layers, f32: the loss and every gradient;
  9. train yi-6b at full width and 8 of its 32 layers through
     ``repro_torch.launch.train.main`` (batch 4, seq 1024, 6 steps, bf16
     compute, f32 master weights, full remat, AdamW) and check the kernel
     launches of every step: 2 forward (the forward and the remat
     recompute), 1 dq and 1 dk/dv per layer;
 10. print one JSON line with every ported kernel, then the result line.

Exits non-zero without a result line when no CUDA card is present or the
port is not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "src/repro_torch/kernels/flash_attention/csrc/"
KERNEL_SOURCE = CSRC + "flash_fwd.cu"
BWD_SOURCE = CSRC + "flash_bwd.cu"
TPU_KERNEL = "src/repro/kernels/flash_attention/kernel.py:90"
TPU_DQ = "src/repro/kernels/flash_attention/kernel.py:223"
TPU_DKV = "src/repro/kernels/flash_attention/kernel.py:241"
OUT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX package's bounds
LSE_TOL = 1e-3       # f32 on both sides, sums over up to 1024 keys
MODEL_TOL = 1e-3     # f32 logits over 4096-wide sums, card vs CPU
# gradients: max|err| / max|ref|; f32 the JAX package's bound
# (tests/test_kernels_flash.py), bf16 the rounding of 8-bit mantissas
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_GRAD_TOL = 1e-3  # f32 train step card vs CPU, per gradient, relative
TRAIN_LOSS_TOL = 1e-4  # f32 loss card vs CPU, absolute
TRAIN_LAYERS = 8     # of yi-6b's 32: 16 B/param of f32 state must fit 80 GB


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
    """(kernel<dtype,D>, "N registers, spills") per instantiation, from the
    ``-Xptxas -v`` report of a build."""
    import re

    entry, spills = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                          r"I(f|13__nv_bfloat16)Li(\d+)E", m.group(1))
            entry = (f"{t.group(1)}<{'f32' if t.group(2) == 'f' else 'bf16'},"
                     f"{t.group(3)}>" if t else m.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield entry, f"{line.split(':', 1)[-1].strip()}; {spills}"


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

COUNTS = ("launches", "bwd_dq_launches", "bwd_dkv_launches")
KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")


def reset_counts(ops) -> None:
    """Set every kernel's launch count to 0, just before a path runs."""
    for attr in COUNTS:
        setattr(ops.flash_attention, attr, 0)


def read_counts(ops) -> dict:
    return {name: getattr(ops.flash_attention, attr)
            for name, attr in zip(KERNEL_NAMES, COUNTS)}


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
        ("f32 D=64", dict(B=2, T=512, H=8, K=2, D=64, dtype="float32",
                          causal=True, window=None)),
    ]

    def inputs(c):
        q, k, v = qkv(c["B"], c["T"], c["H"], c["K"], c["D"], c["dtype"])
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        out, lse = ref.flash_attention_ref(q, k, v, causal=c["causal"],
                                           window=c["window"])
        return q, k, v, out, lse, do

    result = {"abs_err": {}, "rel_err": {}}
    for label, c in cases:
        q, k, v, out, lse, do = inputs(c)
        mask = dict(causal=c["causal"], window=c["window"])
        got = ops.flash_attention_bwd(q, k, v, out, lse, do, **mask)
        torch.cuda.synchronize()
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **mask)
        rels = [rel_err(a, b) for a, b in zip(got, want)]
        abss = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        tol = GRAD_TOL[c["dtype"]]
        ok = all(r < tol for r in rels) and all(
            a.dtype == b.dtype and a.shape == b.shape
            for a, b in zip(got, want))
        print(f"[6] {label:14s} dq/dk/dv max|err|/max|ref| "
              f"{rels[0]:.3e} / {rels[1]:.3e} / {rels[2]:.3e} (< {tol:g}), "
              f"max|err| {abss[0]:.3e} / {abss[1]:.3e} / {abss[2]:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"backward kernels disagree with the plain version: {label}")
        if label == "training":
            result["abs_err"] = {"dq": abss[0], "dkv": max(abss[1:])}
            result["rel_err"] = {"dq": rels[0], "dkv": max(rels[1:])}
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
    for m, d in ((m_gpu, dev), (m_cpu, cpu)):
        st = adamw.init_state(dict(m.named_parameters()))
        metrics.append(step(m, st, {k: v.to(d) for k, v in batch.items()}))
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
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(abs(loss_gpu - loss_cpu) < TRAIN_LOSS_TOL,
          "train loss on the card disagrees with the CPU")
    check(worst < TRAIN_GRAD_TOL,
          "train gradients on the card disagree with the CPU")
    del m_gpu, m_cpu, cpu_grads, metrics
    torch.cuda.empty_cache()

    # 9. the training path at the slice's size
    steps, B, T = 6, 4, 1024
    reset_counts(ops)
    losses, stats = train.main([
        "--arch", "yi-6b", "--preset", "full", "--layers", str(TRAIN_LAYERS),
        "--batch", str(B), "--seq", str(T), "--steps", str(steps)])
    counts = read_counts(ops)
    L = stats["layers"]
    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L}
    print(f"[9] train yi-6b full width, {L} layers, {stats['params']:,} "
          f"params, B={B} T={T}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"[9] step ms {', '.join(f'{x:.1f}' for x in stats['step_ms'])}; "
          f"mean after the first {stats['mean_step_ms']:.1f} ms, "
          f"{stats['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{stats['peak_memory_bytes']} B "
          f"({stats['peak_memory_bytes'] / 2**30:.2f} GiB); launches {counts}",
          flush=True)
    check(L == TRAIN_LAYERS, f"trained {L} layers, not {TRAIN_LAYERS}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"non-finite or missing train losses: {losses}")
    check(all(s == per_step for s in stats["launches"]),
          f"launches per step {stats['launches']}, expected {per_step}")
    check(counts == {k: steps * n for k, n in per_step.items()},
          f"launches over the run {counts}, expected {steps} x {per_step}")
    return counts, stats


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}")
    sys.path.insert(0, src)
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] device: {kind} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card, flush=True)

    # 2. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = kernel.build()
    build_s = time.perf_counter() - t0
    print(f"[2] built {', '.join(p.name for p in libs.values())} "
          f"in {build_s:.1f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            for kernel_name, report in ptxas_report(log.read_text()):
                print(f"    ptxas {kernel_name}: {report}")

    # 3. kernel against its plain version on the card
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, T, H, K, D, dtype):
        dt = getattr(torch, dtype)
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((B, T, H, D), (B, T, K, D), (B, T, K, D))]

    serving = dict(B=4, T=1024, H=32, K=4, D=128, dtype="bfloat16",
                   causal=True, window=None)
    cases = [
        ("serving", serving),
        ("ragged T=1000", dict(serving, T=1000)),
        ("window=256", dict(serving, window=256)),
        ("non-causal", dict(serving, causal=False)),
        ("f32 D=64", dict(B=2, T=512, H=8, K=2, D=64, dtype="float32",
                          causal=True, window=None)),
    ]
    errs = {}
    for label, c in cases:
        q, k, v = qkv(c["B"], c["T"], c["H"], c["K"], c["D"], c["dtype"])
        out, lse = ops.flash_attention(q, k, v, causal=c["causal"],
                                       window=c["window"])
        torch.cuda.synchronize()
        r_out, r_lse = ref.flash_attention_ref(q, k, v, causal=c["causal"],
                                               window=c["window"])
        e_out = float((out.float() - r_out.float()).abs().max())
        e_lse = float((lse - r_lse).abs().max())
        ok = e_out < OUT_TOL[c["dtype"]] and e_lse < LSE_TOL
        errs[label] = (e_out, e_lse)
        print(f"[3] {label:14s} out max|err| {e_out:.3e} "
              f"(< {OUT_TOL[c['dtype']]:g}), lse {e_lse:.3e} (< {LSE_TOL:g})"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"kernel disagrees with its plain version: {label}")
        del q, k, v, out, lse, r_out, r_lse

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
    print(f"[5] yi-6b width, 2 layers, f32: card vs CPU logits max|err| "
          f"{worst:.3e} (< {MODEL_TOL:g}) over prefill + 3 decode steps")
    check(worst < MODEL_TOL, "model on the card disagrees with the CPU")

    # 5b. serve yi-6b at full width: the serving path
    B, P, G = 4, 1024, 32
    reset_counts(ops)
    tokens, stats = serve.main(["--arch", "yi-6b", "--preset", "full",
                                "--batch", str(B), "--prompt-len", str(P),
                                "--gen", str(G), "--seed", "0"])
    serve_counts = read_counts(ops)
    launches = serve_counts["flash_attention_fwd"]
    full = get_config("yi-6b", "full")
    steps = {c["name"]: c["metrics"] for c in stats["tree"]["children"]}
    dec = steps["serve/decode_step"]
    print(f"[5] decode step ms: min {dec['min'] * 1e3:.2f}, max "
          f"{dec['max'] * 1e3:.2f}, mean {dec['sum'] / dec['count'] * 1e3:.2f}"
          f" over {dec['count']} steps")
    print(f"[5] serve: prefill {stats['prefill_ms']:.1f} ms, decode "
          f"{stats['decode_tok_s']:.1f} tok/s, peak memory "
          f"{stats['peak_memory_bytes']} B, kernel launches {launches}",
          flush=True)
    check(launches == full.n_layers == stats["prefill_kernel_launches"],
          f"expected {full.n_layers} kernel launches in one prefill, "
          f"got {launches}")
    check(serve_counts["flash_attention_bwd_dq"]
          == serve_counts["flash_attention_bwd_dkv"] == 0,
          f"backward kernels launched while serving: {serve_counts}")
    check(stats["logits_finite"], "non-finite serve logits")
    check(tuple(tokens.shape) == (B, G + 1), f"tokens {tuple(tokens.shape)}")
    check(0 <= int(tokens.min()) and int(tokens.max()) < full.vocab_size,
          "generated token out of range")

    bwd = backward_phases(qkv)
    train_counts, train_stats = train_phases()

    # 10. result lines
    paths = {"serve": serve_counts, "train": train_counts}

    def launches_of(name):
        by_path = {p: c[name] for p, c in paths.items()}
        return sum(by_path.values()), by_path

    shape = "B=4 T=1024 H=32 K=4 D=128 bf16 causal"
    fwd_total, fwd_paths = launches_of("flash_attention_fwd")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": fwd_total,
        "launches_by_path": fwd_paths,
        "max_abs_err": errs["serving"][0],
        "lse_max_abs_err": errs["serving"][1],
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
        "shape": shape,
        "card": card,
    }]
    for part, replaces in (("dq", TPU_DQ), ("dkv", TPU_DKV)):
        total, by_path = launches_of(f"flash_attention_bwd_{part}")
        t = bwd["timing"][part]
        kernels.append({
            "name": f"flash_attention_bwd_{part}",
            "route": "cuda",
            "source": BWD_SOURCE,
            "replaces": replaces,
            "launches": total,
            "launches_by_path": by_path,
            "max_abs_err": bwd["abs_err"][part],
            "rel_err": bwd["rel_err"][part],
            "ms": t["ms"],
            "plain_ms": bwd["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": bwd["library_ms"],
            "shape": shape,
            "card": card,
        })
    print(json.dumps({"kernels": kernels,
                      "train": {k: train_stats[k] for k in (
                          "layers", "params", "step_ms", "mean_step_ms",
                          "tokens_per_s", "peak_memory_bytes")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        fail("unhandled exception")
