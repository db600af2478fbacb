#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final line):
  1. the card: name, count, power limit (nvidia-smi);
  2. build the CUDA kernels (flash-attention forward; backward dq and
     dk/dv; selective scan and its backward) from this checkout's sources,
     one nvcc per source, in parallel; print what ptxas says of each
     instantiation (registers, spills), the dynamic shared memory and
     blocks an SM of the bf16 tensor-core (wgmma) forward, dq and dk/dv
     kernels and of the scan's forward and backward, and check in the scan's SASS (cuobjdump) that every
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
     jamba, ``launch.train`` for yi-6b and, with 6 steps, for jamba; the
     smoke preset: bf16, head dim 16), each held to the same call with
     ``--device cpu``: the prefill logits, the first tokens where no near
     tie decides them, the train losses, every attention on the wgmma D =
     16 variants, and jamba's 14 scan forwards and 7 backwards a step;
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
 21. (after phase 4) the forward at head dim 256 at gemma3-12b's prefill
     shape (B=4, T=2048, H=16, K=8), bf16 (wgmma) and f32 (scalar),
     causal and with gemma3's window of 1024, against its plain version;
     the bf16 kernel's time (twice), its plain version's,
     scaled_dot_product_attention's (causal; a boolean band mask for the
     window; the backend it ran) and the least time the card could take;
 22. serve gemma3-12b at full width (48 layers, 40 with a window of 1024,
     head dim 256, bf16; batch 4, prompt 2048, 32 new tokens) with eager
     and captured decode in turns: the same tokens, 48 wgmma forwards a
     prefill; then one pattern group in f32 (window cut to 64, prompt
     160, batch 2, 8 new tokens) on the card, decoding through the
     captured step, against the CPU;
 23. captured against eager decode, three times each in turns, on the
     models of phases 5c and 13 (yi-6b, jamba): the same tokens as each
     other and as phases 5 and 13, decode ms a step of every run; then
     phase 18's yi-6b decode trace retaken on one replay of the captured
     step, beside the replay's time by CUDA events;
 24. serve xlstm-125m at full width (12 layers, bf16; batch 4, prompt
     1024, 32 new tokens) with eager and captured decode in turns; then
     two layers (one mLSTM, one sLSTM) in f32 on the card against the
     CPU;
 25. (after phase 21) the dq and dk/dv kernels at head dim 256 against
     the plain backward at gemma3-12b's training shape (B=2, T=2048,
     H=16, K=8), bf16 (wgmma) and f32 (scalar): causal, gemma3's window
     of 1024, a window of 48 that starts inside a tile, a ragged T of
     2000; two bf16 dq launches bit-identical; the bf16 kernels' times
     (twice), the plain backward's, scaled_dot_product_attention's
     backward (the backend it ran) and the least time the card could
     take, causal and at the window of 1024;
 26. train gemma3-12b at full width and 6 of its 48 layers (one pattern
     group: 5 windowed at 1024, 1 global; head dim 256) through
     ``launch.train.main`` (batch 2, seq 2048, 6 steps, bf16 compute, f32
     master weights, full remat, AdamW): 12 forwards, 6 dq and 6 dk/dv a
     step, all wgmma at D = 256; one profiled step as phase 18's; then
     one f32 step of two layers (one windowed, its window cut to 64, one
     global) at full width on the card against the CPU;
 27. train granite-moe-3b-a800m at full width and 16 of its 32 layers
     (batch 4, seq 1024, 4 steps; the MoE aux and load balance non-zero,
     every attention on the wgmma D = 64 kernels) and xlstm-125m at full
     width, all 12 layers (batch 4, seq 512, 3 steps); then each in f32,
     two layers at full width, one step on the card against the CPU
     (granite on a batch that makes an expert overflow);
 28. (after phase 27) the selective scan's backward kernel against the
     plain backward (autograd through the plain scan) on phase 10's six
     cases, every gradient (dx, ddt, dA, dB, dC, dD) within the bound of
     its dtype, two launches at the training shape bit for bit; its time
     there (twice), the plain backward's and the least time the card could
     take; then train jamba-v0.1-52b at full width, one pattern group (8
     layers), the expert width cut to 1024, with ``launch.train``'s step
     functions (batch 4, seq 1024, 4 steps, bf16 compute, f32 master
     weights, full remat, AdamW): 14 scan forwards, 7 scan backwards, 2
     flash forwards, 1 dq and 1 dk/dv a step, the MoE aux loss and load
     balance finite and > 0; one profiled step as phase 18's; then one f32
     step of one pattern group at full mixer width (d_ff and d_expert
     512; batch 2, seq 100) on the card against the CPU;
 29. train llama-3.2-vision-11b at full width and 10 of its 40 layers
     (two pattern groups: 10 self-attention layers, 2 of which add a
     gated cross-attention sublayer over 4096 encoder embeddings) through
     ``launch.train.main`` (batch 4, seq 1024, 4 steps, bf16 compute, f32
     master weights, full remat, AdamW): 24 forwards a step (20 causal at
     T = S = 1024, 4 non-causal at T 1024 against S 4096), 12 dq and 12
     dk/dv (2 of each non-causal), all wgmma at head dim 128; one profiled
     step as phase 18's, whose counted forward FLOPs must split so; then
     one f32 pattern group at narrow width (T 100, encoder_len 160, the
     gates at 0.5) on the card against the CPU;
29b. the forward, dq and dk/dv at the cross-attention's shape (B=4, T=1024,
     S=4096, H=32, K=8, D=128, bf16, non-causal) against their plain
     versions; their times (twice), the plain versions',
     scaled_dot_product_attention's forward and backward and the least
     time the card could take;
 30. train musicgen-large at full width and depth (48 layers, frame input,
     4 codebooks; batch 4, seq 1024, 4 steps): 96 forwards, 48 dq and 48
     dk/dv a step, all causal wgmma at head dim 64; one profiled step;
     then 2 layers at narrow width in f32 on the card against the CPU;
     then, as 29b, the three kernels at its attention's shape (B=4,
     T=S=1024, H=K=32, D=64, bf16, causal) against their plain versions,
     timed beside their bounds and SDPA;
30b. the "dots" remat policy: one f32 step of phase 8's model under
     "dots" and "full" (equal gradients), then 3 steps of phase 9's model
     under each, step ms and peak memory beside phase 9's;
 31. the sharded train step on the card: a one-rank NCCL process group
     from a ``FileStore`` in a temporary directory and a (1,1)
     ``DeviceMesh``; phase 9's cell (yi-6b, full width, 8 layers, B 4, T
     1024, bf16 compute, f32 masters, full remat) trained 3 steps on plain
     tensors, then 3 steps from the same weights and batches on DTensor
     parameters placed by the sharding rules (``tree_shardings``,
     ``distribute_tensor``) under ``sharding_context``, the flash kernels
     on local shards through ``local_map``: equal losses, equal first-step
     gradients, equal flash launches by shape; both step times;
31b. the rest of the sharded path: ``compressed_psum`` over phase 31's
     gradients at world size 1 (the identity within half a quantization
     step, the error buffer the residual); a checkpoint saved by the plain
     launcher (smoke preset, B 8, T 256) resumed through ``reshard_state``
     on the (1,1) mesh, whose losses must continue an unbroken run's;
 32. the ported examples on the card: ``examples/quickstart_torch.py`` (8
     steps of the smoke preset) and ``examples/train_e2e_torch.py`` (its
     tiny preset, 300 steps), finite losses that fall;
 14. print one JSON line with every ported kernel, then the result line.

Serving (phases 5, 13, 15, 20, 22-24) decodes through one captured CUDA
graph a step (``launch.serve.generate``), unless a phase asks for eager
decode; decode ms a step is timed by CUDA events around each step.

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
SCAN_BWD_SOURCE = ("src/repro_torch/kernels/mamba_scan/csrc/"
                   "selective_scan_bwd.cu")
# no Pallas kernel: the JAX package's gradient is jax.grad through its jnp
# chunked scan
TPU_SCAN_BWD = ("no Pallas kernel: jax.grad of the jnp chunked scan, "
                "src/repro/models/mamba.py:121-131")
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
# the scan's cases of phases 10 and 28: jamba's serving and training shape
# (B=4, T=1024, d_inner 8192, d_state 16, x bf16, dt/B/C f32), a ragged
# length and width, f32, all-bf16, d_state 4 and 8
SCAN_SERVING = dict(B=4, T=1024, dI=8192, N=16, x="bfloat16", p="float32")
SCAN_CASES = [
    ("serving", SCAN_SERVING),
    ("ragged T=1000 dI=8000", dict(SCAN_SERVING, T=1000, dI=8000)),
    ("f32", dict(B=2, T=512, dI=1024, N=16, x="float32", p="float32")),
    ("all-bf16", dict(SCAN_SERVING, p="bfloat16")),
    ("d_state 4", dict(SCAN_SERVING, N=4)),
    ("d_state 8", dict(SCAN_SERVING, N=8)),
]
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
# gemma3-12b's prefill attention (phase 21) and serving shape (phase 22):
# B, P, G; the card-vs-CPU check's window, prompt, batch and new tokens
GEMMA_ATTENTION = dict(B=4, T=2048, H=16, K=8, D=256)
GEMMA_WINDOW = 1024
GEMMA_SERVE = (4, 2048, 32)
GEMMA_CHECK = (64, 160, 2, 8)
XLSTM_SERVE = (4, 1024, 32)
# the D = 256 backward at gemma3-12b's training shape (phase 25); the
# training runs of phases 26 and 27: (layers, batch, seq, steps), layers
# cut to what 16 B a parameter of f32 state leaves room for in 80 GB
GEMMA_TRAIN_ATTENTION = dict(B=2, T=2048, H=16, K=8, D=256)
GEMMA_TRAIN = (6, 2, 2048, 6)
GRANITE_TRAIN = (16, 4, 1024, 4)
# xlstm's sLSTM loop is host-bound: seq cut to 512 (a step at 1024 took
# ~20 s on the H100)
XLSTM_TRAIN = (12, 4, 512, 3)
# the f32 card-vs-CPU train steps of phases 26 and 27: (batch, seq);
# gemma3's windowed layer cut to a window of 64, so that it acts at T 160
TRAIN_CHECK = {"gemma3-12b": (2, 160), "granite-moe-3b-a800m": (2, 100),
               "xlstm-125m": (2, 64)}
GEMMA_TRAIN_CHECK_WINDOW = 64
DECODE_REPEATS = 3   # captured and eager decode in turns (phase 23)
# the scan's launches a step of a model without mamba layers
NO_SCAN = {"selective_scan": 0, "selective_scan_bwd": 0}
# phase 28: jamba trained at full width on one pattern group (8 layers),
# (batch, seq, steps); one group at full width is 13.3e9 parameters, 213 GB
# at 16 B a parameter of f32 state, so the expert width is cut from 14336
# (2.83e9 parameters, 45 GB); the f32 card-vs-CPU step's (batch, seq),
# seq ragged against the scan's 16- and 32-step tiles
JAMBA_TRAIN = (4, 1024, 4)
JAMBA_TRAIN_D_EXPERT = 1024
JAMBA_TRAIN_CHECK = (2, 100)
# steps of the default jamba train command on the card and the CPU (phase
# 15; the CPU runs the plain scan, ~2 s a step)
JAMBA_DEFAULT_STEPS = 6
# phase 29: llama-3.2-vision-11b trained at full width on 10 of its 40
# layers, two pattern groups (10 self-attention layers, 2 of them with a
# gated cross-attention sublayer;
# 3.316e9 parameters, ~58 GB at the 17.5 B a parameter that jamba's step
# peaked at; 40 layers are 10.11e9, ~162 GB): (layers, batch, seq,
# steps); its f32 card-vs-CPU step, one pattern group at narrow width (G
# = 4 and head dim 128 kept), T 100 against encoder_len 160, both ragged
# against the kernels' 64-row tiles: (batch, seq) and the config changes
VLM = "llama-3.2-vision-11b"
VLM_TRAIN = (10, 4, 1024, 4)
VLM_CHECK = (2, 100)
VLM_CHECK_CFG = dict(d_model=512, n_heads=4, n_kv_heads=1, d_ff=1024,
                     encoder_len=160)
# every cross-attention gate of a card-vs-CPU check: at its init of 0,
# tanh(0) = 0 zeroes the sublayer's output and every gradient into it
CROSS_GATE = 0.5
# phase 29b: the cross-attention's shape, T 1024 queries against S =
# encoder_len 4096 keys, non-causal
CROSS_ATTENTION = dict(B=4, T=1024, S=4096, H=32, K=8, D=128, causal=False)
# phase 30: musicgen-large trained at full width and depth (48 layers,
# 3.238e9 parameters): (layers, batch, seq, steps); its f32 card-vs-CPU
# step, 2 layers at narrow width (head dim 64 kept): (batch, seq) and the
# config changes
AUDIO = "musicgen-large"
AUDIO_TRAIN = (48, 4, 1024, 4)
AUDIO_CHECK = (2, 100)
AUDIO_CHECK_CFG = dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=8,
                       d_ff=1024)
# musicgen-large's attention in phase 30's training: causal, head dim 64,
# one query head a kv head
AUDIO_ATTENTION = dict(B=4, T=1024, S=1024, H=32, K=32, D=64, causal=True)
# phase 30b: steps of each remat policy on phase 9's yi-6b model
DOTS_STEPS = 3
# phase 31: steps of phase 9's model on plain tensors and on DTensors
SHARDED_STEPS = 3
# phase 31: the sharded step against the plain one on a (1,1) mesh, where
# DTensor runs the same local operations: losses relative, first-step
# gradients max|err| / max|ref|, both f32 round-off
SHARDED_TOL = 1e-6
# phase 31b: the plain launcher's run that saves at step 2 and the
# unbroken run it continues: (batch, seq, steps)
RESUME_RUN = (8, 256, 4)
T0 = 0.0             # the run's start on the host clock
CARD = ""            # nvidia-smi's name and power limit, named by each phase
# the flash kernels' rows: (part, name, the TPU kernel, the source)
FLASH_PARTS = (("fwd", "flash_attention_fwd", TPU_KERNEL, KERNEL_SOURCE),
               ("dq", "flash_attention_bwd_dq", TPU_DQ, BWD_SOURCE),
               ("dkv", "flash_attention_bwd_dkv", TPU_DKV, BWD_SOURCE))
# each kernel's design on the bf16 main paths
DESIGN = {"flash_attention_fwd": "wgmma", "flash_attention_bwd_dq": "wgmma",
          "flash_attention_bwd_dkv": "wgmma",
          "selective_scan": "states split over lanes, cp.async ring",
          "selective_scan_bwd": "16-step sub-tiles recomputed from the "
                                "states saved every 16 steps and walked "
                                "back in registers, 4 steps at a time "
                                "(one ex2 a state), reduce-scatter lane "
                                "sums, dx and ddt through a shared tile, "
                                "per-block partial sums"}
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
            u = re.search(r"(selective_scan(?:_bwd)?_kernel)I"
                          r"(f|13__nv_bfloat16)"
                          r"(f|13__nv_bfloat16|S\d*_)Li(\d+)E"
                          r"(Lb1E)?", entry)
            w = re.search(r"((?:flash_fwd_wgmma|flash_fwd_f32|"
                          r"flash_bwd_dq_wgmma|flash_bwd_dq_f32|"
                          r"flash_bwd_dkv_wgmma|flash_bwd_dkv_f32|"
                          r"wgmma_probe)_kernel)"
                          r"ILi(\d+)E", entry)
            if w:
                entry = f"{w.group(1)}<{w.group(2)}>"
            elif u:
                # a repeated type is a substitution (S<n>_): bf16, bf16
                # the forward's instantiation for training saves states
                entry = (f"{u.group(1)}<x {types[u.group(2)]}, dt/B/C "
                         f"{types.get(u.group(3), types[u.group(2)])}, "
                         f"N={u.group(4)}{', saving' if u.group(5) else ''}>")
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield entry, f"{line.split(':', 1)[-1].strip()}; {spills}"


def scan_bound_ms(work, sms, clock_hz):
    """Least time for one scan call (forward or backward), from the work
    ``(f32 FLOPs, ex2 evaluations, bytes)`` that
    ``repro_torch.core.cost.scan_work`` or ``scan_bwd_work`` counts: the
    bytes (each input read once, each output written once), the f32 FLOPs
    at the f32 peak, and the ex2 on the SFU, at ``SFU_PER_CLOCK_SM`` a
    clock on each SM at the card's top SM clock. Returns (ms, what bounds
    it, detail)."""
    flops, exps, nbytes = work
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
            ("selective_scan", selective_scan, "launches"),
            ("selective_scan_bwd", selective_scan, "bwd_launches"))


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


def card_vs_cpu_step(cfg, B: int, T: int) -> dict:
    """One f32 train step of ``cfg`` on the card and on the CPU, from the
    same weights (drawn on the card from seed 0, every cross-attention gate
    set to ``CROSS_GATE``) and batch (``launch.train``'s synthetic batch of
    step 0, its encoder embeddings at unit scale).
    Returns both losses and MoE aux losses, the worst gradient as max|err|
    / max|ref| with its name, the number of gradients, the card's flash
    launches by variant, the smallest max|gradient| of a cross-attention
    projection (None without one), and the aux vector of a no-grad train
    forward of the card's model before the step (its last entry the
    fraction of (token, choice) pairs that overflowing experts dropped)."""
    import gc

    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step, model_inputs

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    t0 = time.perf_counter()
    m_gpu = Model(cfg, dev, trainable=True).init_weights(0)
    with torch.no_grad():
        for n, p in m_gpu.named_parameters():
            if n.endswith(".gate"):
                p.fill_(CROSS_GATE)
    m_cpu = Model(cfg, cpu, trainable=True)
    m_cpu.load_state_dict(m_gpu.state_dict())
    batch = to_device(SyntheticTokens(cfg, DataConfig(batch=B, seq_len=T)
                                      ).batch_at(0), cpu)
    if "encoder_embeddings" in batch:
        # drawn at unit scale, not the launcher's 0.02: at 0.02 the
        # cross-attention's scores are near 0 and its projections' gradients
        # near 1e-7, too small to hold the kernels' gradients to anything
        batch["encoder_embeddings"] /= 0.02
    with torch.no_grad():
        inputs, enc = model_inputs({k: v.to(dev) for k, v in batch.items()})
        _, aux = m_gpu(inputs, mode="train", enc=enc)
    step = make_train_step(cfg, adamw.AdamWConfig())
    reset_counts()
    metrics = []
    for m, d in ((m_gpu, dev), (m_cpu, cpu)):
        state = adamw.init_state(dict(m.named_parameters()))
        got = step(m, state, {k: v.to(d) for k, v in batch.items()})
        metrics.append({k: float(got[k]) for k in ("loss", "moe_aux")})
        del state, got
    used = read_variants()
    scans = {k: n for k, n in read_counts().items() if k in NO_SCAN}
    cpu_grads = {n: p.grad for n, p in m_cpu.named_parameters()}
    worst, worst_name = 0.0, ""
    cross = []
    for n, p in m_gpu.named_parameters():
        check(bool(torch.isfinite(p.grad).all()), f"non-finite gradient {n}")
        r = rel_err(p.grad.cpu(), cpu_grads[n])
        if r > worst:
            worst, worst_name = r, n
        if ".cross.w" in n:
            cross.append(float(p.grad.abs().max()))
    out = {"loss": [x["loss"] for x in metrics],
           "moe_aux": [x["moe_aux"] for x in metrics],
           "worst_grad_rel_err": worst, "worst_grad": worst_name,
           "grads": len(cpu_grads), "launched": used, "scans": scans,
           "cross_grad_min_abs_max": min(cross) if cross else None,
           "aux": [float(x) for x in aux], "B": B, "T": T}
    del m_gpu, m_cpu, cpu_grads, aux
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def step_check(tag: str, label: str, cfg, B: int, T: int) -> dict:
    """Phases 8 and 26-30: :func:`card_vs_cpu_step`, printed and held to
    ``TRAIN_LOSS_TOL`` and ``TRAIN_GRAD_TOL``; every attention layer (and
    every cross-attention sublayer) on the card must run the scalar f32
    forward, dq and dk/dv, once each, every mamba layer the scan's forward
    and backward kernels, and every cross-attention projection must get a
    non-zero gradient."""
    r = card_vs_cpu_step(cfg, B, T)
    n_attn = cfg.n_groups * sum((s.mixer == "attn") + s.cross_attn
                                for s in cfg.pattern)
    n_mamba = cfg.n_groups * sum(s.mixer == "mamba" for s in cfg.pattern)
    want = {k: n_attn for k in ("fwd/scalar", "dq/scalar", "dkv/scalar")
            if n_attn}
    scans = {"selective_scan": n_mamba, "selective_scan_bwd": n_mamba}
    # the remat recomputes each layer's forward
    if cfg.remat != "none":
        scans["selective_scan"] *= 2
        if "fwd/scalar" in want:
            want["fwd/scalar"] *= 2
    print(f"[{tag}] {label}, f32, B={B} T={T}: card vs CPU loss "
          f"{r['loss'][0]:.6f} vs {r['loss'][1]:.6f} (|diff| < "
          f"{TRAIN_LOSS_TOL:g}), moe_aux {r['moe_aux'][0]:.6e} vs "
          f"{r['moe_aux'][1]:.6e}, worst gradient max|err|/max|ref| "
          f"{r['worst_grad_rel_err']:.3e} ({r['worst_grad']}, < "
          f"{TRAIN_GRAD_TOL:g}) over {r['grads']} gradients, smallest "
          f"max|grad| of a cross-attention projection "
          f"{r['cross_grad_min_abs_max']}, aux vector "
          f"{[round(x, 6) for x in r['aux']]}, {r['seconds']:.1f} s; card "
          f"launches {r['launched']}, {r['scans']}", flush=True)
    check(r["launched"] == want and r["scans"] == scans,
          f"{label}: the f32 train step launched {r['launched']}, "
          f"{r['scans']}; {want}, {scans} expected")
    check(abs(r["loss"][0] - r["loss"][1]) < TRAIN_LOSS_TOL
          and abs(r["moe_aux"][0] - r["moe_aux"][1]) < TRAIN_LOSS_TOL,
          f"{label}: train loss on the card disagrees with the CPU")
    check(r["worst_grad_rel_err"] < TRAIN_GRAD_TOL,
          f"{label}: train gradients on the card disagree with the CPU")
    check(r["cross_grad_min_abs_max"] != 0.0,
          f"{label}: a cross-attention projection got no gradient")
    return r


def train_phases():
    """Phase 8: one train step on the card against the CPU; phase 9: the
    training path at the slice's size; phase 18: a profiled step. Returns
    (launch counts of the training path, its stats, the traced step)."""
    import torch

    from repro_torch.configs.archs import get_config

    # 8. one train step, card vs CPU, full width, 2 layers, f32
    cfg = dataclasses.replace(get_config("yi-6b", "full"), n_layers=2,
                              dtype="float32")
    step_check("8", "yi-6b width, 2 layers", cfg, 2, 100)

    # 9. the training path at the slice's size
    steps, B, T = 6, 4, 1024
    losses, stats, counts = train_run("9", "yi-6b", TRAIN_LAYERS, B, T, steps)
    L = stats["layers"]
    check_train_launches("yi-6b", stats, counts, steps, (L, 0), 128)

    # 18. one profiled step of the same model and shape (train.main frees
    # its model when it returns: a model of the same seed takes its place)
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("yi-6b", "full"), n_layers=L)
    traced = traced_train_step(f"yi-6b train step ({L} layers, B={B} T={T})",
                               cfg, B, T)
    return counts, stats, traced


def scan_inputs(c: dict, gen) -> tuple:
    """x, dt, A, Bc, Cc, D of scan case ``c`` on the card, drawn from
    ``gen`` with the distribution of tests/test_kernels_mamba.py."""
    import torch

    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    xt, pt = getattr(torch, c["x"]), getattr(torch, c["p"])
    B, T, dI, N = c["B"], c["T"], c["dI"], c["N"]
    x = rn(B, T, dI).to(xt)
    dt = torch.nn.functional.softplus(rn(B, T, dI) - 2).to(pt)
    A = -torch.exp(rn(dI, N) * 0.5)
    return x, dt, A, rn(B, T, N).to(pt), rn(B, T, N).to(pt), rn(dI)


def scan_phases(sms: int, clock_hz: float) -> dict:
    """Phases 10 and 11: the scan kernel against its plain version on the
    card, then its time at the serving shape."""
    import torch

    from repro_torch.core import cost
    from repro_torch.kernels.mamba_scan import kernel, ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = lambda c: scan_inputs(c, gen)
    result = {}
    for label, c in SCAN_CASES:
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
    c = SCAN_SERVING
    args = inputs(c)
    run = lambda: kernel.selective_scan(*args, return_state=True)
    k_ms = cuda_ms(run)
    plain_ms = cuda_ms(lambda: ref.selective_scan_ref(*args), iters=3,
                       warmup=1)
    k2_ms = cuda_ms(run)
    bound_ms, bound_by, detail = scan_bound_ms(
        cost.scan_work(c["B"], c["T"], c["dI"], c["N"], 2, 4), sms, clock_hz)
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
    from repro_torch.core.collector import reset_global_collector
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
    dec = decode_steps(stats)
    want = {"flash_attention_fwd": cfg.n_groups * sum(
        s.mixer == "attn" for s in cfg.pattern), "selective_scan":
        cfg.n_groups * sum(s.mixer == "mamba" for s in cfg.pattern)}
    numbers = {
        "layers": cfg.n_layers, "params": n_params, "batch": B, "prompt": P,
        "gen": G, "init_s": init_s, "prefill_ms": stats["prefill_ms"],
        "decode_ms_min": dec["min_ms"], "decode_ms_max": dec["max_ms"],
        "decode_ms_mean": dec["mean_ms"], "decode_captured": dec["captured"],
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
          f" over {G} steps, captured {dec['captured']} "
          f"({stats['decode_tok_s']:.1f} tok/s); "
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
                     "flash_attention_bwd_dkv": 0, "selective_scan_bwd": 0},
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

    # 23. captured against eager decode on the served model, in turns
    turns = captured_vs_eager(
        "23", f"jamba ({cfg.n_layers} layers, B={B} P={P} G={G})", model,
        prompts, G)
    turns.pop("stats")
    check(torch.equal(turns.pop("tokens"), tokens.cpu()),
          "phase 23's jamba tokens differ from phase 13's")
    numbers["captured_vs_eager"] = turns

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
    and ``python -m repro_torch.launch.train`` (yi-6b, and jamba with
    ``JAMBA_DEFAULT_STEPS`` steps) with their default arguments (the smoke
    preset: bf16, head dim 16) on the card, each held to the same call
    with ``--device cpu``. Returns {path: launch counts}."""
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

    # jamba's default train command, fewer steps (the CPU's plain scan)
    argv = ["--arch", "jamba-v0.1-52b", "--steps", str(JAMBA_DEFAULT_STEPS)]
    cfg = get_config("jamba-v0.1-52b", "smoke")
    n_attn = cfg.n_groups * sum(s.mixer == "attn" for s in cfg.pattern)
    n_mamba = cfg.n_groups * sum(s.mixer == "mamba" for s in cfg.pattern)
    reset_counts()
    losses, stats = train.main(argv)
    counts["train_jamba_default"] = read_counts()
    cpu_losses, _ = train.main(argv + ["--device", "cpu"])
    diff = max(abs(a - b) for a, b in zip(losses, cpu_losses))
    want = {"flash_attention_fwd": 2 * n_attn,
            "flash_attention_bwd_dq": n_attn,
            "flash_attention_bwd_dkv": n_attn,
            "selective_scan": 2 * n_mamba, "selective_scan_bwd": n_mamba}
    per_step = variants_of({("fwd", "bfloat16"): 2 * n_attn,
                            ("dq", "bfloat16"): n_attn,
                            ("dkv", "bfloat16"): n_attn})
    print(f"[15] train_jamba_default: jamba-v0.1-52b smoke (d_state 4, "
          f"d_inner 128, D={cfg.head_dim}), {len(losses)} steps: losses card "
          f"vs CPU max|diff| {diff:.3e} (< {DEFAULT_LOSS_TOL:g}); first "
          f"{losses[0]:.5f} / {cpu_losses[0]:.5f}, last {losses[-1]:.5f} / "
          f"{cpu_losses[-1]:.5f}; moe_aux {stats['moe_aux'][-1]:.4e}; "
          f"launches {counts['train_jamba_default']}, each step {want}, "
          f"{per_step}", flush=True)
    check(len(losses) == len(cpu_losses) == JAMBA_DEFAULT_STEPS and all(
        math.isfinite(x) for x in losses), "train_jamba_default: bad losses")
    check(diff < DEFAULT_LOSS_TOL,
          "train_jamba_default: losses on the card disagree with the CPU")
    check(all(s == want for s in stats["launches"])
          and all({k: n for k, n in s.items() if n} == per_step
                  for s in stats["launches_by_variant"]),
          f"train_jamba_default launches {stats['launches']}, by variant "
          f"{stats['launches_by_variant']}: {want}, {per_step} a step "
          "expected")
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
           "selective_scan": "selective_scan_kernel",
           "selective_scan_bwd": "selective_scan_bwd_kernel"}
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
    if selective_scan.bwd_launches:
        counted["selective_scan_bwd"] = selective_scan.bwd_launches
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
            "launches_in_trace": seen, "kernel_work": tally.kernels}


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
    """Decode ms a step of a serve run (``stats["decode_step_ms"]``: CUDA
    events around each step, since a captured step's region closes when
    its replay is launched), with the step count and whether decode ran as
    one captured graph."""
    d = stats["decode_step_ms"]
    return {"min_ms": d["min"], "mean_ms": d["mean"], "max_ms": d["max"],
            "captured": stats["decode_captured"]}


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
    # the card decodes from the first step's launch until the end of the
    # loop's synchronize: a captured step's region closes at its launch
    lo = min(e.t_start for e in decode)
    hi = max(max(e.t_end for e in decode), lo + stats["decode_s"] * 1e9)
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
          f"{dec['min_ms']:.2f}, max {dec['max_ms']:.2f}; captured "
          f"{dec['captured']}) beside "
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


def sdpa_backend(fn) -> str:
    """The backend that ``scaled_dot_product_attention`` ran ``fn`` on,
    from the aten op a host-side profile of one call shows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    for backend in ("flash", "efficient", "cudnn"):
        if f"aten::_scaled_dot_product_{backend}_attention" in names:
            return backend
    if "aten::_scaled_dot_product_attention_math" in names:
        return "math"
    return "unknown: " + ", ".join(sorted(n for n in names if "dot" in n))


def d256_phase(reports) -> dict:
    """Phase 21: the forward at head dim 256 at gemma3's prefill shape,
    bf16 (wgmma) and f32 (scalar), causal (a global layer) and with
    gemma3's window of 1024 (a local layer), against its plain version;
    then, in bf16, the kernel's time by CUDA events (twice), its plain
    version's, scaled_dot_product_attention's (yardstick only: causal for
    the global layer, a boolean band mask for the windowed one, with the
    backend it ran) and the least time the card could take. Returns
    {"<dtype> <case>": numbers}."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.kernels.flash_attention.ops import flash_attention

    t0 = time.perf_counter()
    B, T, H, K, D = (GEMMA_ATTENTION[x] for x in "BTHKD")
    gen = torch.Generator(device="cuda").manual_seed(21)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((B, T, H, D), (B, T, K, D), (B, T, K, D)))
        for case, window in (("causal", None), ("window", GEMMA_WINDOW)):
            reset_counts()
            o, lse = flash_attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            used = read_variants()
            r_o, r_lse = ref.flash_attention_ref(q, k, v, causal=True,
                                                 window=window)
            row = {"max_abs_err": float((o.float() - r_o.float()).abs().max()),
                   "lse_max_abs_err": float((lse - r_lse).abs().max()),
                   "launched": used}
            del o, lse, r_o, r_lse
            ok = (row["max_abs_err"] < OUT_TOL[dtype]
                  and row["lse_max_abs_err"] < LSE_TOL
                  and used == variants_of({("fwd", dtype): 1}))
            label = f"{dtype} {case}"
            print(f"[21] D=256 {label} (B={B} T=S={T} H={H} K={K}, window "
                  f"{window}): out max|err| {row['max_abs_err']:.3e} (< "
                  f"{OUT_TOL[dtype]:g}), lse {row['lse_max_abs_err']:.3e} "
                  f"(< {LSE_TOL:g}); {used} {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"the D=256 forward disagrees with its plain version: "
                      f"{label}")

            def run():
                return kernel.flash_fwd(q, k, v, causal=True, window=window)

            row["ms"] = cuda_ms(run)
            if dtype == "bfloat16":
                row["plain_ms"] = cuda_ms(lambda: ref.flash_attention_ref(
                    q, k, v, causal=True, window=window), iters=3, warmup=1)
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                if window is None:
                    def lib():
                        return sdpa(qt, kt, vt, is_causal=True,
                                    enable_gqa=True)
                else:
                    p = torch.arange(T, device="cuda")
                    band = ((p[None, :] <= p[:, None])
                            & (p[None, :] > p[:, None] - window))

                    def lib():
                        return sdpa(qt, kt, vt, attn_mask=band,
                                    enable_gqa=True)
                row["library_ms"] = cuda_ms(lib)
                row["library_backend"] = sdpa_backend(lib)
                (row["bound_ms"], row["bound_by"], flops,
                 nbytes) = attention_bound_ms(B, T, T, H, K, D, True, window,
                                              2, PEAK_BF16_FLOPS)
                row["ms_again"] = cuda_ms(run)
                del qt, kt, vt
                print(f"[21] D=256 {label}: kernel {row['ms']:.4f} / "
                      f"{row['ms_again']:.4f} ms, plain {row['plain_ms']:.3f}"
                      f" ms, sdpa {row['library_ms']:.4f} ms "
                      f"({row['library_backend']}); bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                      f"{flops:.4e} FLOP, {nbytes / 1e6:.1f} MB), kernel at "
                      f"{row['bound_ms'] / row['ms']:.2%} of bound; {CARD}",
                      flush=True)
            else:
                print(f"[21] D=256 {label}: scalar kernel {row['ms']:.3f} ms;"
                      f" {CARD}", flush=True)
            out[label] = row
        del q, k, v
    torch.cuda.empty_cache()
    for name in ("flash_fwd_wgmma_kernel<256>", "flash_fwd_f32_kernel<256>",
                 "fwd wgmma D=256 smem"):
        print(f"[21] {name}: {reports.get(name)}", flush=True)
    print(f"[21] took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def windowed(cfg, window: int):
    """``cfg`` with every local layer's window replaced by ``window``."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=window if s.window else None)
        for s in cfg.pattern))


def captured_vs_eager(tag: str, label: str, model, prompts, G: int,
                      repeats: int = DECODE_REPEATS) -> dict:
    """Serve ``prompts`` through ``launch.serve.generate`` with eager and
    with captured decode, in turns, ``repeats`` times each: the tokens must
    be equal in every run. Returns decode ms a step of each run, prefill
    ms, the largest difference of the last step's logits, and the first
    captured run's launch counts, variants and stats."""
    import torch

    from repro_torch.launch import serve

    runs = {False: [], True: []}
    first = None
    for _ in range(repeats):
        for captured in (False, True):
            reset_counts()
            tokens, stats = serve.generate(model, prompts, G,
                                           captured=captured)
            counts, used = read_counts(), read_variants()
            runs[captured].append((tokens.cpu(), decode_steps(stats), stats))
            if captured and first is None:
                first = {"counts": counts, "variants": used, "stats": stats}
    want = runs[False][0][0]
    same = all(torch.equal(t, want) for r in runs.values() for t, _, _ in r)
    diff = max(float((c[2]["decode_logits"] - e[2]["decode_logits"]).abs()
                     .max()) for c, e in zip(runs[True], runs[False]))
    steps = {("captured" if c else "eager"): [
        {k: round(d[f"{k}_ms"], 3) for k in ("min", "mean", "max")}
        for _, d, _ in r] for c, r in runs.items()}
    prefill = {("captured" if c else "eager"): [
        round(s["prefill_ms"], 2) for _, _, s in r] for c, r in runs.items()}
    print(f"[{tag}] {label}: captured and eager tokens equal over "
          f"{2 * repeats} runs: {same}; last step's logits max|diff| "
          f"{diff:.3e}; decode ms a step (min, mean, max) by run {steps}; "
          f"prefill ms {prefill}; {CARD}", flush=True)
    check(same, f"{label}: captured decode changed the tokens of eager "
                f"decode")
    check(all(d["captured"] for _, d, _ in runs[True])
          and not any(d["captured"] for _, d, _ in runs[False]),
          f"{label}: decode_captured does not match the request")
    return {"tokens_equal": same, "logits_max_diff": diff,
            "decode_step_ms": steps, "prefill_ms": prefill,
            "tokens": want, **first}


def captured_trace(label: str, model, prompts, cfg) -> dict:
    """Phase 23: phase 18's decode trace retaken on the captured step: one
    profiled replay at the position after the prompt, its idle share,
    busy ms and events by kernel, beside the replay's time by CUDA events
    (which holds whatever the trace shows of a graph's kernels)."""
    import torch

    from repro_torch.core import device_timeline
    from repro_torch.train.step import CapturedDecode, make_prefill_step

    B, P = prompts.shape
    caches = model.alloc_cache(B, P + 1)
    graph = CapturedDecode(model, caches, B)
    with torch.no_grad():
        logits = make_prefill_step(cfg)(model, {"tokens": prompts}, caches)
    token = logits[:, 0].argmax(dim=-1).to(torch.int32)[:, None]

    def step():
        return graph(token, P)

    event_ms = cuda_ms(step, iters=10, warmup=2)
    _, trace = device_timeline.profile(step)
    # every event by kernel class, whether or not it joins a host span
    rep = device_timeline.device_report(trace,
                                        phases=(device_timeline.WINDOW,))
    by_class = {}
    for row in rep["by_phase"].values():
        for c, ms in row.items():
            by_class[c] = by_class.get(c, 0.0) + ms
    kernels = sum(e.get("cat") == "kernel" for e in trace["traceEvents"])
    launches = sum(e.get("name") == "cudaGraphLaunch"
                   for e in trace["traceEvents"])
    print(f"[23] {label} (captured): replay {event_ms:.3f} ms by CUDA events;"
          f" trace: {kernels} kernels, {launches} cudaGraphLaunch, window "
          f"{rep['window_ms']:.3f} ms, busy {rep['busy_ms']:.3f} ms, idle "
          f"share {rep['idle_share']:.4f}; {CARD}", flush=True)
    for k in rep["kernels"][:5]:
        print(f"[23]   kernel {k['ms']:9.3f} ms {k['launches']:5d}x  "
              f"{k['name'][:100]}", flush=True)
    for g in rep["idle_gaps"][:3]:
        print(f"[23]   idle {g['ms']:8.3f} ms at {g['at_ms']:9.3f} ms, host "
              f"in {' < '.join(g['host_path']) or '(no span)'}", flush=True)
    print(f"[23]   busy ms by kernel class "
          f"{ {c: round(ms, 3) for c, ms in sorted(by_class.items())} }",
          flush=True)
    del graph, caches
    return {"replay_event_ms": event_ms, "trace_kernels": kernels,
            "graph_launches": launches, "window_ms": rep["window_ms"],
            "busy_ms": rep["busy_ms"], "idle_share": rep["idle_share"],
            "events": rep["events"], "idle_gaps": rep["idle_gaps"][:3],
            "busy_ms_by_class": by_class}


def gemma3_phase() -> tuple:
    """Phase 22: serve gemma3-12b at full width (48 layers, bf16, head dim
    256, 40 layers with a window of 1024), B 4, prompt 2048, 32 new tokens,
    with captured and with eager decode in turns; then one pattern group
    in f32 on the card against the CPU. Returns (the launch counts of the
    first captured run, its numbers)."""
    import gc

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train.step import (CapturedDecode, make_decode_step,
                                        make_prefill_step)

    t0 = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    full = get_config("gemma3-12b", "full")
    B, P, G = GEMMA_SERVE
    torch.cuda.reset_peak_memory_stats(dev)
    model = Model(full, dev).init_weights(0)
    n_params = sum(p.numel() for p in model.parameters())
    prompts = torch.randint(0, full.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    turns = captured_vs_eager("22", "gemma3-12b", model, prompts, G,
                              repeats=2)
    stats = turns.pop("stats")
    want = {"fwd/wgmma": full.n_layers}
    numbers = {
        "layers": full.n_layers, "params": n_params, "batch": B, "prompt": P,
        "gen": G, **{k: v for k, v in turns.items() if k != "tokens"},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "prefill_launches_by_variant": {
            k: n for k, n in stats["prefill_launches_by_variant"].items()
            if n}}
    print(f"[22] serve gemma3-12b full width, {full.n_layers} layers "
          f"({sum(s.window is not None for s in full.pattern) * full.n_groups}"
          f" windowed), {n_params:,} params, B={B} P={P} G={G}: prefill ms "
          f"{turns['prefill_ms']}, decode ms a step {turns['decode_step_ms']},"
          f" peak memory {numbers['peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"launches {turns['counts']} {turns['variants']}; {CARD}",
          flush=True)
    check(numbers["prefill_launches_by_variant"] == turns["variants"] == want
          and turns["counts"]["flash_attention_fwd"] == full.n_layers,
          f"gemma3 prefill launched {turns['variants']} ({turns['counts']}):"
          f" {want} expected")
    check(stats["logits_finite"], "non-finite gemma3 logits")
    tokens = turns["tokens"]
    check(tuple(tokens.shape) == (B, G + 1)
          and 0 <= int(tokens.min()) and int(tokens.max()) < full.vocab_size,
          f"gemma3 tokens {tuple(tokens.shape)} out of shape or range")
    counts = turns["counts"]
    del model, prompts, stats, turns
    gc.collect()
    torch.cuda.empty_cache()

    # one pattern group at full width, f32, the window cut so that it acts
    # inside a short prefill; the card decodes through the captured step
    W, Pc, Bc, Gc = GEMMA_CHECK
    cfg = dataclasses.replace(windowed(full, W), n_layers=len(full.pattern),
                              dtype="float32")
    m_gpu = Model(cfg, dev).init_weights(0)
    m_cpu = Model(cfg, cpu)
    m_cpu.load_state_dict(m_gpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (Bc, Pc + Gc),
                         generator=torch.Generator().manual_seed(0))
    reset_counts()
    results = []
    with torch.no_grad():
        for m, d in ((m_gpu, dev), (m_cpu, cpu)):
            caches = m.alloc_cache(Bc, Pc + Gc)
            if d.type == "cuda":
                step = CapturedDecode(m, caches, Bc)
            else:
                def step(tok, t, m=m, caches=caches):
                    return make_decode_step(cfg)(m, caches, {"tokens": tok}, t)
            logits = [make_prefill_step(cfg)(
                m, {"tokens": toks[:, :Pc].to(d)}, caches)]
            for t in range(Pc, Pc + Gc):
                logits.append(step(toks[:, t:t + 1].to(d), t)[0].clone())
            results.append([x.cpu() for x in logits])
            del caches, step
    used = read_variants()
    worst = 0.0
    for a, b in zip(*results):
        check(bool(torch.isfinite(a).all()), "non-finite gemma3 logits")
        worst = max(worst, float((a - b).abs().max()))
    del m_gpu, m_cpu, results
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[22] gemma3 full width, {cfg.n_layers} layers (one pattern "
          f"group), f32; reduced: window {W}, prompt {Pc}, B {Bc}, {Gc} "
          f"new tokens: card (captured decode) vs CPU logits max|err| "
          f"{worst:.3e} (< {MODEL_TOL:g}) over prefill + {Gc} decode steps; "
          f"card launches {used}", flush=True)
    check(worst < MODEL_TOL, "gemma3 on the card disagrees with the CPU")
    check(used == {"fwd/scalar": cfg.n_layers},
          f"the f32 gemma3 prefill launched {used}: "
          f"{cfg.n_layers} scalar forwards expected")
    numbers["check_max_abs_err"] = worst
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[22] took {numbers['phase_s']:.1f} s", flush=True)
    return counts, numbers


def xlstm_phase() -> dict:
    """Phase 24: serve xlstm-125m at full width (12 layers, bf16), B 4,
    prompt 1024, 32 new tokens, captured against eager decode; then two
    layers (one mLSTM, one sLSTM) in f32 on the card against the CPU."""
    import gc

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train.step import (CapturedDecode, make_decode_step,
                                        make_prefill_step)

    t0 = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    full = get_config("xlstm-125m", "full")
    B, P, G = XLSTM_SERVE
    model = Model(full, dev).init_weights(0)
    n_params = sum(p.numel() for p in model.parameters())
    prompts = torch.randint(0, full.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    turns = captured_vs_eager("24", "xlstm-125m", model, prompts, G,
                              repeats=2)
    stats = turns.pop("stats")
    check(stats["logits_finite"], "non-finite xlstm logits")
    check(sum(turns["counts"].values()) == 0,
          f"xlstm launched a hand-written kernel: {turns['counts']}")
    numbers = {"layers": full.n_layers, "params": n_params, "batch": B,
               "prompt": P, "gen": G,
               **{k: v for k, v in turns.items() if k != "tokens"}}
    print(f"[24] serve xlstm-125m full width, {full.n_layers} layers, "
          f"{n_params:,} params, B={B} P={P} G={G}: prefill ms "
          f"{turns['prefill_ms']} (the sLSTM prefill a loop of {P} steps), "
          f"decode ms a step {turns['decode_step_ms']}; {CARD}", flush=True)
    del model, prompts, stats, turns
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
    m_gpu = Model(cfg, dev).init_weights(0)
    m_cpu = Model(cfg, cpu)
    m_cpu.load_state_dict(m_gpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(0))
    results = []
    with torch.no_grad():
        for m, d in ((m_gpu, dev), (m_cpu, cpu)):
            caches = m.alloc_cache(2, 100)
            if d.type == "cuda":
                step = CapturedDecode(m, caches, 2)
            else:
                def step(tok, t, m=m, caches=caches):
                    return make_decode_step(cfg)(m, caches, {"tokens": tok}, t)
            logits = [make_prefill_step(cfg)(
                m, {"tokens": toks[:, :97].to(d)}, caches)]
            for t in range(97, 100):
                logits.append(step(toks[:, t:t + 1].to(d), t)[0].clone())
            results.append([x.cpu() for x in logits])
            del caches, step
    worst = 0.0
    for a, b in zip(*results):
        check(bool(torch.isfinite(a).all()), "non-finite xlstm logits")
        worst = max(worst, float((a - b).abs().max()))
    del m_gpu, m_cpu, results
    print(f"[24] xlstm full width, 2 layers (mLSTM, sLSTM), f32: card "
          f"(captured decode) vs CPU logits max|err| {worst:.3e} (< "
          f"{MODEL_TOL:g}) over prefill + 3 decode steps", flush=True)
    check(worst < MODEL_TOL, "xlstm on the card disagrees with the CPU")
    numbers["check_max_abs_err"] = worst
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[24] took {numbers['phase_s']:.1f} s", flush=True)
    return numbers


def d256_backward_phase(reports) -> dict:
    """Phase 25: the dq and dk/dv kernels at head dim 256 against the plain
    backward at gemma3's training shape, bf16 (wgmma) and f32 (scalar):
    causal (a global layer), gemma3's window of 1024 (a local layer), a
    window of 48 that starts inside a 64-key tile, and a ragged T of 2000
    with the window of 1024; two bf16 dq launches must be bit-identical.
    Then, in bf16, causal and at the window of 1024: the kernels' times
    by CUDA events (twice), the plain backward's, the backward of
    scaled_dot_product_attention (yardstick only; the backend it ran) and
    the least time the card could take. Returns {"<dtype> <case>":
    numbers}."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    t0 = time.perf_counter()
    B, T, H, K, D = (GEMMA_TRAIN_ATTENTION[x] for x in "BTHKD")
    gen = torch.Generator(device="cuda").manual_seed(25)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = (("causal", T, None), ("window", T, GEMMA_WINDOW),
             ("window 48", T, 48), ("ragged T=2000", 2000, GEMMA_WINDOW))
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for case, Tc, window in cases:
            q, k, v, do = (torch.randn(shape, generator=gen,
                                       device="cuda").to(dt)
                           for shape in ((B, Tc, H, D), (B, Tc, K, D),
                                         (B, Tc, K, D), (B, Tc, H, D)))
            o, lse = ref.flash_attention_ref(q, k, v, window=window)
            reset_counts()
            got = ops.flash_attention_bwd(q, k, v, o, lse, do, window=window)
            torch.cuda.synchronize()
            used = read_variants()
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                               window=window)
            rels = [rel_err(a, b) for a, b in zip(got, want)]
            abss = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want)]
            del got, want
            label = f"{dtype} {case}"
            row = {"dq_rel": rels[0], "dkv_rel": max(rels[1:]),
                   "dq": abss[0], "dkv": max(abss[1:]), "launched": used}
            tol = GRAD_TOL[dtype]
            ok = (all(r < tol for r in rels) and used == variants_of(
                {("dq", dtype): 1, ("dkv", dtype): 1}))
            print(f"[25] D=256 {label:22s} (B={B} T=S={Tc} H={H} K={K}, "
                  f"window {window}): dq/dk/dv max|err|/max|ref| "
                  f"{rels[0]:.3e} / {rels[1]:.3e} / {rels[2]:.3e} (< "
                  f"{tol:g}), max|err| {abss[0]:.3e} / {abss[1]:.3e} / "
                  f"{abss[2]:.3e}; {used} {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"the D=256 backward disagrees with the plain "
                      f"backward: {label}")
            delta = (do.float() * o.float()).sum(-1).transpose(
                1, 2).contiguous()
            if dtype == "bfloat16" and case == "causal":
                # each block owns its dq tile: no atomics, the same bits
                twice = [kernel.flash_bwd_dq(q, k, v, do, lse, delta)
                         for _ in range(2)]
                torch.cuda.synchronize()
                row["dq_bit_identical"] = torch.equal(*twice)
                print(f"[25] D=256 {label}: two dq launches bit-identical: "
                      f"{row['dq_bit_identical']}", flush=True)
                check(row["dq_bit_identical"],
                      "two launches of the D=256 dq kernel differ")
                del twice
            if case in ("causal", "window"):
                def run_dq():
                    return kernel.flash_bwd_dq(q, k, v, do, lse, delta,
                                               window=window)

                def run_dkv():
                    return kernel.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                window=window)

                row["dq_ms"], row["dkv_ms"] = cuda_ms(run_dq), cuda_ms(run_dkv)
                if dtype == "bfloat16":
                    row["plain_ms"] = cuda_ms(
                        lambda: ref.flash_attention_bwd_ref(
                            q, k, v, o, lse, do, window=window),
                        iters=3, warmup=1)
                    qt, kt, vt = (x.transpose(1, 2).contiguous()
                                  .requires_grad_() for x in (q, k, v))
                    mask = {"is_causal": True}
                    if window is not None:
                        p = torch.arange(Tc, device="cuda")
                        mask = {"attn_mask": (p[None, :] <= p[:, None])
                                & (p[None, :] > p[:, None] - window)}
                    ot = sdpa(qt, kt, vt, enable_gqa=True, **mask)
                    dot = do.transpose(1, 2).contiguous()

                    def lib():
                        return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                   retain_graph=True)
                    row["library_ms"] = cuda_ms(lib)
                    row["library_backend"] = sdpa_backend(
                        lambda: torch.autograd.grad(
                            sdpa(qt, kt, vt, enable_gqa=True, **mask),
                            (qt, kt, vt), dot))
                    bounds = backward_bound_ms(B, Tc, Tc, H, K, D, True,
                                               window, 2, PEAK_BF16_FLOPS)
                    for part in ("dq", "dkv"):
                        (row[f"{part}_bound_ms"], row[f"{part}_bound_by"],
                         flops, nbytes) = bounds[part]
                        row[f"{part}_flops"], row[f"{part}_bytes"] = (flops,
                                                                      nbytes)
                    row["dq_ms_again"] = cuda_ms(run_dq)
                    row["dkv_ms_again"] = cuda_ms(run_dkv)
                    del qt, kt, vt, ot, dot
                    for part in ("dq", "dkv"):
                        print(f"[25] D=256 {label}: {part} kernel "
                              f"{row[f'{part}_ms']:.4f} / "
                              f"{row[f'{part}_ms_again']:.4f} ms; bound "
                              f"{row[f'{part}_bound_ms']:.4f} ms "
                              f"({row[f'{part}_bound_by']}: "
                              f"{row[f'{part}_flops']:.4e} FLOP, "
                              f"{row[f'{part}_bytes'] / 1e6:.1f} MB), kernel "
                              f"at {row[f'{part}_bound_ms'] / row[f'{part}_ms']:.2%}"
                              f" of bound; {CARD}", flush=True)
                    print(f"[25] D=256 {label}: plain backward (dq, dk, dv "
                          f"together) {row['plain_ms']:.3f} ms; sdpa backward"
                          f" (dq, dk, dv together) {row['library_ms']:.4f} ms "
                          f"({row['library_backend']}); {CARD}", flush=True)
                else:
                    print(f"[25] D=256 {label}: scalar dq {row['dq_ms']:.3f}"
                          f" ms, dk/dv {row['dkv_ms']:.3f} ms; {CARD}",
                          flush=True)
            out[label] = row
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
    for name in ("flash_bwd_dq_wgmma_kernel<256>",
                 "flash_bwd_dkv_wgmma_kernel<256>",
                 "flash_bwd_dq_f32_kernel<256>",
                 "flash_bwd_dkv_f32_kernel<256>", "dq wgmma D=256 smem",
                 "dkv wgmma D=256 smem"):
        print(f"[25] {name}: {reports.get(name)}", flush=True)
    print(f"[25] took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def train_run(tag: str, arch: str, layers: int, B: int, T: int,
              steps: int) -> tuple:
    """Phases 9, 26 and 27: train ``arch`` at full width through
    ``launch.train.main``; print its losses, step ms, tokens/s, peak
    memory and launches; fail unless it trained ``layers`` layers to
    finite losses. Returns (losses, stats, launch counts of the run)."""
    import math

    from repro_torch.launch import train

    reset_counts()
    losses, stats = train.main([
        "--arch", arch, "--preset", "full", "--layers", str(layers),
        "--batch", str(B), "--seq", str(T), "--steps", str(steps)])
    counts = read_counts()
    print(f"[{tag}] train {arch} full width, {stats['layers']} layers, "
          f"{stats['params']:,} params, B={B} T={T}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; moe_aux "
          f"{stats['moe_aux']}, load balance {stats['moe_load_balance']}",
          flush=True)
    print(f"[{tag}] step ms {', '.join(f'{x:.1f}' for x in stats['step_ms'])}"
          f"; mean after the first {stats['mean_step_ms']:.1f} ms, "
          f"{stats['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{stats['peak_memory_bytes']} B "
          f"({stats['peak_memory_bytes'] / 2**30:.2f} GiB); launches "
          f"{counts}; by variant, each step {stats['launches_by_variant'][0]}"
          f"; by head dim and mask, each step "
          f"{stats['launches_by_shape'][0]}; "
          f"{CARD}", flush=True)
    check(stats["layers"] == layers,
          f"{arch}: trained {stats['layers']} layers, not {layers}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{arch}: non-finite or missing train losses: {losses}")
    return losses, stats, counts


def gemma3_train_phase() -> tuple:
    """Phase 26: train gemma3-12b at full width, one pattern group (6 of
    48 layers), B 2, seq 2048, 6 steps: every step 12 forwards (the
    forward and the remat's recompute), 6 dq and 6 dk/dv, all wgmma at
    head dim 256; then one profiled step (phase 18's checks) of a model of
    the same seed; then one f32 step of two layers against the CPU.
    Returns (the run's launch counts, its numbers)."""
    import gc

    import torch

    from repro_torch.configs.archs import get_config

    t0 = time.perf_counter()
    L, B, T, steps = GEMMA_TRAIN
    losses, stats, counts = train_run("26", "gemma3-12b", L, B, T, steps)
    check_train_launches("gemma3-12b", stats, counts, steps, (L, 0), 256)
    numbers = train_numbers(stats, losses, B, T)
    del stats
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("gemma3-12b", "full"), n_layers=L)
    numbers["trace"] = traced_train_step(
        f"gemma3-12b train step ({L} layers, B={B} T={T})", cfg, B, T)

    # two layers, one windowed (its window cut so that it acts at T 160)
    # and the global one, at full width in f32
    full = windowed(get_config("gemma3-12b", "full"), GEMMA_TRAIN_CHECK_WINDOW)
    cfg = dataclasses.replace(full, n_layers=2, dtype="float32",
                              pattern=(full.pattern[0], full.pattern[-1]))
    Bc, Tc = TRAIN_CHECK["gemma3-12b"]
    numbers["check"] = step_check(
        "26", f"gemma3 full width, 2 layers (window {GEMMA_TRAIN_CHECK_WINDOW}"
        ", global)", cfg, Bc, Tc)
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[26] took {numbers['phase_s']:.1f} s", flush=True)
    return counts, numbers


def moe_xlstm_train_phase() -> tuple:
    """Phase 27: train granite-moe-3b-a800m at full width, 16 of its 32
    layers (B 4, seq 1024, 4 steps: the MoE aux loss and load balance
    non-zero and finite every step, every attention on the wgmma D = 64
    kernels), then xlstm-125m at full width, 12 layers (B 4, seq 512, 3
    steps); then each in f32, two layers at full width, one step on the
    card against the CPU (granite on a batch whose experts overflow).
    Returns ({path: launch counts}, numbers)."""
    import gc
    import math

    import torch

    from repro_torch.configs.archs import get_config

    t0 = time.perf_counter()
    paths, numbers = {}, {}
    for arch, (L, B, T, steps) in (("granite-moe-3b-a800m", GRANITE_TRAIN),
                                   ("xlstm-125m", XLSTM_TRAIN)):
        losses, stats, counts = train_run("27", arch, L, B, T, steps)
        full = get_config(arch, "full")
        n_attn = L // len(full.pattern) * sum(s.mixer == "attn"
                                              for s in full.pattern)
        check_train_launches(arch, stats, counts, steps, (n_attn, 0),
                             full.head_dim)
        if n_attn:
            moe = stats["moe_aux"] + stats["moe_load_balance"]
            check(all(math.isfinite(x) and x > 0 for x in moe),
                  f"{arch}: moe_aux {stats['moe_aux']} and load balance "
                  f"{stats['moe_load_balance']} must be finite and > 0")
        name = arch.split("-")[0]
        paths[f"train_{name}"] = counts
        numbers[name] = {k: stats[k] for k in (
            "layers", "params", "step_ms", "mean_step_ms", "tokens_per_s",
            "peak_memory_bytes", "moe_aux", "moe_load_balance")}
        numbers[name].update(losses=losses, batch=B, seq=T)
        del stats
        gc.collect()
        torch.cuda.empty_cache()

        Bc, Tc = TRAIN_CHECK[arch]
        cfg = dataclasses.replace(get_config(arch, "full"), n_layers=2,
                                  dtype="float32")
        r = step_check("27", f"{arch} full width, 2 layers", cfg, Bc, Tc)
        if cfg.moe is not None:
            check(r["aux"][3] > 0, f"{arch}: no expert overflowed in the "
                                   f"card-vs-CPU step: aux {r['aux']}")
        numbers[name]["check"] = r
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[27] took {numbers['phase_s']:.1f} s", flush=True)
    return paths, numbers


def scan_backward_phase(sms: int, clock_hz: float, reports: dict) -> dict:
    """Phase 28 (a, b): the scan's backward kernel against the plain
    backward (autograd through the plain scan) on the forward's six cases,
    each gradient as max|err| / max|ref| within the bound of its dtype, and
    two launches bit for bit at the training shape; then the kernel's time
    there (twice, turn about with the plain backward), its bound (from the
    states at a 32-step interval, the least the gradients need; the extra
    bytes of the 16-step cadence are printed beside it), and what ptxas
    says of it (no spill in any instantiation)."""
    import torch

    from repro_torch.core import cost
    from repro_torch.kernels.mamba_scan import kernel, ref

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(28)
    names = ("dx", "ddt", "dA", "dBc", "dCc", "dD")

    def inputs(c):
        args = scan_inputs(c, gen)
        dy = torch.randn(args[0].shape, generator=gen, device="cuda").to(
            args[0].dtype)
        _, _, chunks = kernel.selective_scan(*args, save_chunks=True)
        return args, dy, chunks

    result = {}
    for label, c in SCAN_CASES:
        args, dy, chunks = inputs(c)
        got = kernel.selective_scan_bwd(*args, dy, chunks)
        torch.cuda.synchronize()
        want = ref.selective_scan_bwd_ref(*args, dy)
        grads, ok = {}, True
        for name, a, b in zip(names, got, want):
            tol = GRAD_TOL[str(a.dtype)[6:]]
            grads[name] = {"rel_err": rel_err(a, b), "tol": tol,
                           "max_abs_err": float((a.float() - b.float())
                                                .abs().max())}
            ok = (ok and a.dtype == b.dtype and a.shape == b.shape
                  and grads[name]["rel_err"] < tol)
        entry = {"grads": grads}
        same = ""
        if label == "serving":
            again = kernel.selective_scan_bwd(*args, dy, chunks)
            torch.cuda.synchronize()
            entry["bit_identical"] = all(torch.equal(a, b)
                                         for a, b in zip(got, again))
            same = f"; two launches bit-identical: {entry['bit_identical']}"
            del again
        print(f"[28] {label:22s} backward max|err|/max|ref| "
              + ", ".join(f"{n} {g['rel_err']:.3e}" for n, g in grads.items())
              + f" (f32 < {GRAD_TOL['float32']:g}, bf16 < "
              f"{GRAD_TOL['bfloat16']:g}){same} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"scan backward kernel disagrees with the plain backward:"
                  f" {label}")
        check(entry.get("bit_identical", True),
              "two launches of the scan backward differ")
        result[label] = entry
        del args, dy, chunks, got, want
        torch.cuda.empty_cache()

    # (b) the training shape, turn about: kernel, plain, kernel
    c = SCAN_SERVING
    args, dy, chunks = inputs(c)
    run = lambda: kernel.selective_scan_bwd(*args, dy, chunks)
    k_ms = cuda_ms(run)
    plain_ms = cuda_ms(lambda: ref.selective_scan_bwd_ref(*args, dy),
                       iters=2, warmup=1)
    k2_ms = cuda_ms(run)
    least = -(-c["T"] // kernel.TILE)
    bound_ms, bound_by, detail = scan_bound_ms(
        cost.scan_bwd_work(c["B"], c["T"], c["dI"], c["N"], 2, 4, least),
        sms, clock_hz)
    saved = chunks.numel() * 4
    extra = saved - c["B"] * least * c["dI"] * c["N"] * 4
    del args, dy, chunks
    torch.cuda.empty_cache()
    ptxas = {k: v for k, v in reports.items()
             if k.startswith("selective_scan_bwd_kernel")}
    key = "selective_scan_bwd_kernel<x bf16, dt/B/C f32, N=16>"
    label = "scan bwd x bfloat16, dt/B/C float32, N=16"
    smem = reports.get(f"{label} smem")
    _, blocks, warps = reports[f"{label} occupancy"]
    print(f"[28] training shape (B=4 T=1024 dI=8192 N=16, x bf16, dt/B/C "
          f"f32): backward kernel {k_ms:.3f} / {k2_ms:.3f} ms, plain "
          f"backward {plain_ms:.3f} ms, no single PyTorch call computes it; "
          f"bound {bound_ms:.4f} ms ({bound_by}: {detail}; states every "
          f"{kernel.TILE} steps), kernel at {bound_ms / k_ms:.2%} of bound; "
          f"saved states every {kernel.SAVE_EVERY} steps {saved} B a layer, "
          f"{extra} B beyond the bound's ({extra / PEAK_BYTES * 1e3:.4f} ms "
          f"at {PEAK_BYTES / 1e12:g} TB/s); ptxas {ptxas.get(key)}; {smem}, "
          f"{warps} warps an SM; SASS {reports.get('scan bwd sass')}; {CARD}",
          flush=True)
    check(len(ptxas) == 9 and all("0 bytes spill stores, 0 bytes spill loads"
                                  in v for v in ptxas.values()),
          f"the scan backward spills or is missing: {ptxas}")
    result["timing"] = {"ms": k_ms, "ms_again": k2_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "saved_state_bytes": saved,
                        "saved_bytes_beyond_bound": extra,
                        "ptxas": ptxas.get(key), "smem": smem,
                        "blocks_per_sm": blocks, "warps_per_sm": warps,
                        "sass": reports.get("scan bwd sass")}
    result["phase_s"] = time.perf_counter() - t0
    print(f"[28] scan backward took {result['phase_s']:.1f} s", flush=True)
    return result


def jamba_train_phase() -> tuple:
    """Phase 28 (c, d, f): train jamba at full width, one pattern group (8
    layers: 7 mamba, 1 attention, 4 MoE), its expert width cut to
    ``JAMBA_TRAIN_D_EXPERT``, with the step functions of ``launch.train``
    (bf16 compute, f32 master weights, full remat, AdamW): finite losses,
    the MoE aux loss and load balance finite and > 0, and every step 14
    scan forwards (the forward and the remat's recompute), 7 scan
    backwards, 2 flash forwards, 1 dq and 1 dk/dv, all wgmma; then one
    profiled step (phase 18's checks); then one f32 step of one pattern
    group at full mixer width on the card against the CPU. Returns (the
    run's launch counts, its numbers)."""
    import gc
    import math

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config("jamba-v0.1-52b", "full")
    B, T, steps = JAMBA_TRAIN
    cfg = dataclasses.replace(
        full, n_layers=len(full.pattern),
        moe=dataclasses.replace(full.moe, d_expert=JAMBA_TRAIN_D_EXPERT))
    n_attn = sum(s.mixer == "attn" for s in cfg.pattern)
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern)
    per_step = {"flash_attention_fwd": 2 * n_attn,
                "flash_attention_bwd_dq": n_attn,
                "flash_attention_bwd_dkv": n_attn,
                "selective_scan": 2 * n_mamba, "selective_scan_bwd": n_mamba}
    variants = variants_of({("fwd", "bfloat16"): 2 * n_attn,
                            ("dq", "bfloat16"): n_attn,
                            ("dkv", "bfloat16"): n_attn})
    check(per_step["selective_scan"] == 14 and n_attn == 1,
          f"jamba's pattern group: {n_mamba} mamba, {n_attn} attention")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = Model(cfg, dev, trainable=True).init_weights(0)
    n_params = sum(p.numel() for p in model.parameters())
    opt_state = adamw.init_state(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.AdamWConfig(
        lr=3e-4, schedule="cosine", warmup_steps=2, total_steps=steps))
    data = SyntheticTokens(cfg, DataConfig(batch=B, seq_len=T))
    losses, step_ms, launches, by_variant, aux, balance = [], [], [], [], [], []
    reset_counts()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in data.batch_at(i).items()}
        before, before_v = read_counts(), read_variants()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        metrics = step(model, opt_state, batch)
        losses.append(float(metrics["loss"]))         # waits for the card
        step_ms.append((time.perf_counter() - ts) * 1e3)
        after = read_counts()
        launches.append({k: after[k] - before[k] for k in after})
        by_variant.append({k: n - before_v.get(k, 0)
                           for k, n in read_variants().items()
                           if n != before_v.get(k, 0)})
        aux.append(float(metrics["moe_aux"]))
        balance.append(float(metrics["moe_load_balance"]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    mean_ms = sum(step_ms[1:]) / (steps - 1)
    numbers = {"layers": cfg.n_layers, "params": n_params, "batch": B,
               "seq": T, "d_expert": JAMBA_TRAIN_D_EXPERT, "losses": losses,
               "step_ms": step_ms, "mean_step_ms": mean_ms,
               "tokens_per_s": B * T / (mean_ms / 1e3),
               "peak_memory_bytes": peak, "moe_aux": aux,
               "moe_load_balance": balance, "launches_per_step": launches[0]}
    print(f"[28] train jamba full width (d 4096, d_inner 8192, d_state 16, "
          f"32/8 heads, d_ff 14336, 16 experts top-2), 8 layers; reduced: "
          f"d_expert 14336 -> {JAMBA_TRAIN_D_EXPERT}; {n_params:,} params, "
          f"B={B} T={T}: losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"moe_aux {aux}, load balance {balance}", flush=True)
    print(f"[28] step ms {', '.join(f'{x:.1f}' for x in step_ms)}; mean "
          f"after the first {mean_ms:.1f} ms, {numbers['tokens_per_s']:.0f} "
          f"tokens/s, peak memory {peak} B ({peak / 2**30:.2f} GiB); "
          f"launches {counts}; each step {launches[0]}, by variant "
          f"{by_variant[0]}; {CARD}", flush=True)
    check(all(math.isfinite(x) for x in losses),
          f"jamba: non-finite train losses {losses}")
    check(all(math.isfinite(x) and x > 0 for x in aux + balance),
          f"jamba: moe_aux {aux} and load balance {balance} must be finite "
          "and > 0")
    check(all(s == per_step for s in launches)
          and all(v == variants for v in by_variant),
          f"jamba launches per step {launches}, by variant {by_variant}: "
          f"{per_step}, {variants} expected")
    check(counts == {k: steps * n for k, n in per_step.items()},
          f"jamba launches over the run {counts}")

    # (f) one profiled step of the same model
    numbers["trace"] = traced_call(
        f"jamba train step (8 layers, d_expert {JAMBA_TRAIN_D_EXPERT}, "
        f"B={B} T={T})", lambda: step(model, opt_state, batch), cfg,
        ShapeConfig("train", T, B, "train"), phases=TRAIN_PHASES)
    del model, opt_state, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # (d) one f32 pattern group at full mixer width against the CPU
    W = JAMBA_CHECK_WIDTH
    ccfg = dataclasses.replace(full, n_layers=len(full.pattern), d_ff=W,
                               moe=dataclasses.replace(full.moe, d_expert=W),
                               dtype="float32")
    numbers["check"] = step_check(
        "28", f"jamba full mixer width, 8 layers, d_ff and d_expert {W}",
        ccfg, *JAMBA_TRAIN_CHECK)
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[28] jamba training took {numbers['phase_s']:.1f} s", flush=True)
    return counts, numbers


def train_numbers(stats: dict, losses: list, B: int, T: int) -> dict:
    """The numbers of a ``train_run`` that the result line keeps."""
    numbers = {k: stats[k] for k in ("layers", "params", "step_ms",
                                     "mean_step_ms", "tokens_per_s",
                                     "peak_memory_bytes")}
    numbers.update(losses=losses, batch=B, seq=T,
                   launches_by_shape=stats["launches_by_shape"][0],
                   launches_by_shape_run={
                       k: sum(s.get(k, 0) for s in stats["launches_by_shape"])
                       for k in stats["launches_by_shape"][0]})
    return numbers


def check_train_launches(label: str, stats: dict, counts: dict, steps: int,
                         layers: tuple, D: int) -> None:
    """Fail unless every step of a bf16 training run under full remat
    launched, for ``layers`` = (causal attention layers, cross-attention
    sublayers), 2 forwards (the forward and the recompute), 1 dq and 1
    dk/dv for each, all wgmma at head dim ``D``, causal and non-causal as
    the layers are, and no scan."""
    causal, cross = layers
    n = causal + cross
    per_step = {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
                "flash_attention_bwd_dkv": n, **NO_SCAN}
    variants = variants_of({("fwd", "bfloat16"): 2 * n,
                            ("dq", "bfloat16"): n, ("dkv", "bfloat16"): n})
    shapes = {f"{k}/{D}/{m}": c * (2 if k == "fwd" else 1)
              for m, c in (("causal", causal), ("non-causal", cross))
              for k in ("fwd", "dq", "dkv") if c}
    check(all(s == per_step for s in stats["launches"])
          and all({k: c for k, c in s.items() if c} == variants
                  for s in stats["launches_by_variant"])
          and all(s == shapes for s in stats["launches_by_shape"]),
          f"{label} launches per step {stats['launches']}, by variant "
          f"{stats['launches_by_variant']}, by head dim and mask "
          f"{stats['launches_by_shape']}: {per_step}, {variants}, {shapes} "
          f"expected")
    check(counts == {k: steps * c for k, c in per_step.items()},
          f"{label} launches over the run {counts}")


def traced_train_step(label: str, cfg, B: int, T: int) -> dict:
    """Phase 18's profiled step (:func:`traced_call`) of a model of
    ``cfg`` (seed 0, as ``launch.train`` draws it) on the synthetic batch of
    step 0; the model is freed after."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    dev = torch.device("cuda")
    model = Model(cfg, dev, trainable=True).init_weights(0)
    opt_state = adamw.init_state(dict(model.named_parameters()))
    batch = to_device(SyntheticTokens(cfg, DataConfig(batch=B, seq_len=T)
                                      ).batch_at(0), dev)
    step = make_train_step(cfg, adamw.AdamWConfig())
    trace = traced_call(label, lambda: step(model, opt_state, batch), cfg,
                        ShapeConfig("train", T, B, "train"),
                        phases=TRAIN_PHASES)
    del model, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return trace


def vlm_train_phase() -> tuple:
    """Phase 29: train llama-3.2-vision-11b at full width, 10 of its 40
    layers (two pattern groups: 10 self-attention layers, 2 of which add
    a gated cross-attention sublayer over 4096 encoder embeddings), B 4,
    seq 1024, 4 steps, through ``launch.train.main``: every step 24
    forwards (20 causal at T = S = 1024, 4 non-causal at T 1024 against S
    4096), 12 dq and 12 dk/dv (2 of each non-causal), all wgmma at head
    dim 128; one profiled step, whose
    counted forward FLOPs must split so; then one f32 pattern group at
    narrow width on the card against the CPU. Returns (the run's launch
    counts, its numbers)."""
    import gc

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.core.cost import attention_work

    t0 = time.perf_counter()
    L, B, T, steps = VLM_TRAIN
    full = get_config(VLM, "full")
    cfg = dataclasses.replace(full, n_layers=L)
    n_self = cfg.n_groups * sum(s.mixer == "attn" for s in cfg.pattern)
    n_cross = cfg.n_groups * sum(s.cross_attn for s in cfg.pattern)
    check((n_self, n_cross) == (10, 2),
          f"{VLM}: {n_self} attention layers, {n_cross} cross-attention")
    losses, stats, counts = train_run("29", VLM, L, B, T, steps)
    check_train_launches(VLM, stats, counts, steps, (n_self, n_cross),
                         cfg.head_dim)
    numbers = train_numbers(stats, losses, B, T)
    del stats
    gc.collect()
    torch.cuda.empty_cache()

    trace = traced_train_step(
        f"{VLM} train step ({L} layers, B={B} T={T}, encoder_len "
        f"{cfg.encoder_len})", cfg, B, T)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    want = 2 * (n_self * attention_work(B, T, T, H, K, D, True, None, 2)[0]
                + n_cross * attention_work(B, T, cfg.encoder_len, H, K, D,
                                           False, None, 2)[0])
    got = trace["kernel_work"]["flash_attention_fwd"]["flops"]
    print(f"[29] counted forward FLOPs a step {got:.6e}: {2 * n_self} causal "
          f"at T = S = {T} and {2 * n_cross} non-causal at S "
          f"{cfg.encoder_len} give {want:.6e}", flush=True)
    check(got == want, f"{VLM}: the forwards' counted FLOPs {got} are not "
          f"those of {2 * n_self} causal and {2 * n_cross} cross calls")
    numbers["trace"] = trace

    ccfg = dataclasses.replace(full, n_layers=len(full.pattern),
                               dtype="float32", **VLM_CHECK_CFG)
    numbers["check"] = step_check(
        "29", f"{VLM} one pattern group, {VLM_CHECK_CFG}, gates "
        f"{CROSS_GATE}", ccfg, *VLM_CHECK)
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[29] took {numbers['phase_s']:.1f} s", flush=True)
    return counts, numbers


def attention_shape_phase(tag: str, label: str, c: dict) -> dict:
    """Phases 29b and 30: the forward, dq and dk/dv kernels at a training
    path's attention shape (``c``: B, T, S, H, K, D, causal; bf16) against
    their plain versions on the card, with the bounds of phases 3 and 6;
    then each kernel's time (twice), the plain versions', scaled_dot_
    product_attention's forward and backward (yardstick only) and the
    least time the card could take."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    t0 = time.perf_counter()
    B, T, S, H, K, D, causal = (c[x] for x in ("B", "T", "S", "H", "K", "D",
                                               "causal"))
    mask = "causal" if causal else "non-causal"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(tag[:2]))
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)
    q, do = rn(B, T, H, D), rn(B, T, H, D)
    k, v = rn(B, S, K, D), rn(B, S, K, D)
    reset_counts()
    out, lse = ops.flash_attention(q, k, v, causal=causal)
    r_out, r_lse = ref.flash_attention_ref(q, k, v, causal=causal)
    got = ops.flash_attention_bwd(q, k, v, r_out, r_lse, do, causal=causal)
    torch.cuda.synchronize()
    used = read_variants()
    want = ref.flash_attention_bwd_ref(q, k, v, r_out, r_lse, do,
                                       causal=causal)
    e_out = float((out.float() - r_out.float()).abs().max())
    e_lse = float((lse - r_lse).abs().max())
    rels = [rel_err(a, b) for a, b in zip(got, want)]
    abss = [float((a.float() - b.float()).abs().max())
            for a, b in zip(got, want)]
    tol = GRAD_TOL["bfloat16"]
    print(f"[{tag}] {label} (B={B} T={T} S={S} H={H} K={K} D={D}, bf16, "
          f"{mask}): out max|err| {e_out:.3e} (< {OUT_TOL['bfloat16']:g})"
          f", lse {e_lse:.3e} (< {LSE_TOL:g}); dq/dk/dv max|err|/max|ref| "
          f"{rels[0]:.3e} / {rels[1]:.3e} / {rels[2]:.3e} (< {tol:g}), "
          f"max|err| {abss[0]:.3e} / {abss[1]:.3e} / {abss[2]:.3e}; {used}",
          flush=True)
    check(used == {"fwd/wgmma": 1, "dq/wgmma": 1, "dkv/wgmma": 1},
          f"the {label} launched {used}")
    check(e_out < OUT_TOL["bfloat16"] and e_lse < LSE_TOL,
          f"the forward disagrees with its plain version at the {label}")
    check(all(r < tol for r in rels),
          f"the backward kernels disagree with the plain version at the "
          f"{label}")
    del got, want

    delta = (do.float() * r_out.float()).sum(-1).transpose(1, 2).contiguous()
    r_lse = r_lse.contiguous()
    run = {"fwd": lambda: kernel.flash_fwd(q, k, v, causal=causal),
           "dq": lambda: kernel.flash_bwd_dq(q, k, v, do, r_lse, delta,
                                             causal=causal),
           "dkv": lambda: kernel.flash_bwd_dkv(q, k, v, do, r_lse, delta,
                                               causal=causal)}
    ms = {name: cuda_ms(fn) for name, fn in run.items()}
    plain_fwd = cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                        causal=causal),
                        iters=3, warmup=1)
    plain_bwd = cuda_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, r_out, r_lse, do, causal=causal), iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                   enable_gqa=True))
    ot = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                  retain_graph=True))
    backend = sdpa_backend(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                        enable_gqa=True))
    again = {name: cuda_ms(fn) for name, fn in run.items()}
    bounds = {"fwd": attention_bound_ms(B, T, S, H, K, D, causal, None, 2,
                                        PEAK_BF16_FLOPS)}
    bounds.update(backward_bound_ms(B, T, S, H, K, D, causal, None, 2,
                                    PEAK_BF16_FLOPS))
    result = {"shape": f"B={B} T={T} S={S} H={H} K={K} D={D} bf16 {mask}",
              "max_abs_err": {"fwd": e_out, "dq": abss[0],
                              "dkv": max(abss[1:])},
              "rel_err": {"dq": rels[0], "dkv": max(rels[1:])},
              "lse_max_abs_err": e_lse, "plain_ms": {"fwd": plain_fwd,
                                                     "bwd": plain_bwd},
              "library_ms": {"fwd": lib_fwd, "bwd": lib_bwd},
              "library_backend": backend, "timing": {}}
    for name in run:
        b_ms, b_by, flops, nbytes = bounds[name]
        result["timing"][name] = {"ms": ms[name], "ms_again": again[name],
                                  "bound_ms": b_ms, "bound_by": b_by}
        print(f"[{tag}] {name}: kernel {ms[name]:.3f} / {again[name]:.3f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {flops:.3e} FLOP, "
              f"{nbytes / 1e6:.1f} MB), kernel at {b_ms / ms[name]:.2%} of "
              f"bound", flush=True)
    print(f"[{tag}] plain forward {plain_fwd:.3f} ms, plain backward (dq, dk, "
          f"dv together) {plain_bwd:.3f} ms; sdpa forward {lib_fwd:.3f} ms, "
          f"backward (dq, dk, dv together) {lib_bwd:.3f} ms ({backend}); "
          f"{CARD}", flush=True)
    del q, k, v, do, out, lse, r_out, r_lse, delta, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t0
    print(f"[{tag}] {label} took {result['phase_s']:.1f} s", flush=True)
    return result


def audio_train_phase() -> tuple:
    """Phase 30: train musicgen-large at full width and depth (48 layers,
    frame input, 4 codebooks), B 4, seq 1024, 4 steps, through
    ``launch.train.main``: every step 96 forwards, 48 dq and 48 dk/dv, all
    causal wgmma at head dim 64; one profiled step; then 2 layers at narrow
    width in f32 on the card against the CPU. Returns (the run's launch
    counts, its numbers)."""
    import gc

    import torch

    from repro_torch.configs.archs import get_config

    t0 = time.perf_counter()
    L, B, T, steps = AUDIO_TRAIN
    full = get_config(AUDIO, "full")
    check(full.n_layers == L and full.input_mode == "frames",
          f"{AUDIO}: {full.n_layers} layers, input {full.input_mode}")
    shape = (full.n_heads, full.n_kv_heads, full.head_dim, B, T)
    want = tuple(AUDIO_ATTENTION[x] for x in ("H", "K", "D", "B", "T"))
    check(shape == want, f"{AUDIO}'s attention {shape} is not "
                         f"AUDIO_ATTENTION's {want}")
    losses, stats, counts = train_run("30", AUDIO, L, B, T, steps)
    check_train_launches(AUDIO, stats, counts, steps, (L, 0), full.head_dim)
    numbers = train_numbers(stats, losses, B, T)
    del stats
    gc.collect()
    torch.cuda.empty_cache()
    numbers["trace"] = traced_train_step(
        f"{AUDIO} train step ({L} layers, B={B} T={T})", full, B, T)
    ccfg = dataclasses.replace(full, dtype="float32", **AUDIO_CHECK_CFG)
    numbers["check"] = step_check("30", f"{AUDIO} {AUDIO_CHECK_CFG}", ccfg,
                                  *AUDIO_CHECK)
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[30] took {numbers['phase_s']:.1f} s", flush=True)
    return counts, numbers


def _count_mm_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    import torch

    class CountMM(TorchDispatchMode):
        """Counts the ``aten.mm`` calls dispatched inside it."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    return CountMM


def dots_phase(full_stats: dict) -> tuple:
    """Phase 30b: the "dots" remat policy on the card. One f32 train step
    of phase 8's 2-layer yi-6b under "dots" and under "full", from the same
    weights and batch: every gradient equal; then ``DOTS_STEPS`` steps of
    phase 9's model (8 layers, B 4, T 1024) under each policy, "dots"
    first: step ms and peak memory, beside phase 9's, and one profiled
    step of each (phase 18's). Returns (the dots run's launch counts, its
    numbers)."""
    import gc
    import math

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    CountMM = _count_mm_mode()
    cfg = dataclasses.replace(get_config("yi-6b", "full"), n_layers=2,
                              dtype="float32")
    batch = to_device(SyntheticTokens(cfg, DataConfig(batch=2, seq_len=100)
                                      ).batch_at(0), dev)
    grads, mms = {}, {}
    for remat in ("full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        m = Model(c, dev, trainable=True).init_weights(0)
        with CountMM() as count:
            make_train_step(c, adamw.AdamWConfig(lr=0.0))(
                m, adamw.init_state(dict(m.named_parameters())), batch)
        grads[remat] = {n: p.grad for n, p in m.named_parameters()}
        mms[remat] = count.n
        del m
    worst = max(rel_err(g, grads["full"][n])
                for n, g in grads["dots"].items())
    same = all(torch.equal(g, grads["full"][n])
               for n, g in grads["dots"].items())
    # each layer's 7 products (wq, wk, wv, wo, wg, wi, wo): "full"
    # recomputes the first 6 (the recompute stops after the last tensor the
    # backward needs), "dots" keeps them all
    saved = 6 * cfg.n_layers
    print(f"[30b] yi-6b width, 2 layers, f32: dots vs full gradients, worst "
          f"max|err|/max|ref| {worst:.3e} (< 1e-5), bit-identical {same}; "
          f"aten.mm calls a step {mms} ({saved} fewer under dots expected)",
          flush=True)
    check(worst < 1e-5, "the dots policy changes the gradients")
    check(mms["full"] - mms["dots"] == saved,
          f"dots recomputed products: aten.mm calls {mms}")
    del grads, batch

    L, B, T = TRAIN_LAYERS, 4, 1024
    numbers = {"grad_rel_err": worst, "grads_bit_identical": same,
               "layers": L, "batch": B, "seq": T, "steps": DOTS_STEPS,
               "phase9_full": {k: full_stats[k] for k in (
                   "mean_step_ms", "tokens_per_s", "peak_memory_bytes")}}
    counts = None
    for remat in ("dots", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        c = dataclasses.replace(get_config("yi-6b", "full"), n_layers=L,
                                remat=remat)
        model = Model(c, dev, trainable=True).init_weights(0)
        opt_state = adamw.init_state(dict(model.named_parameters()))
        step = make_train_step(c, adamw.AdamWConfig(
            lr=3e-4, warmup_steps=2, total_steps=DOTS_STEPS))
        data = SyntheticTokens(c, DataConfig(batch=B, seq_len=T))
        reset_counts()
        losses, step_ms = [], []
        for i in range(DOTS_STEPS):
            batch = to_device(data.batch_at(i), dev)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            losses.append(float(step(model, opt_state, batch)["loss"]))
            step_ms.append((time.perf_counter() - ts) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        mean_ms = sum(step_ms[1:]) / (DOTS_STEPS - 1)
        run_counts = read_counts()
        numbers[remat] = {"losses": losses, "step_ms": step_ms,
                          "mean_step_ms": mean_ms,
                          "tokens_per_s": B * T / (mean_ms / 1e3),
                          "peak_memory_bytes": peak, "launches": run_counts}
        trace = traced_call(
            f"yi-6b train step ({L} layers, B={B} T={T}, remat {remat})",
            lambda: step(model, opt_state, batch), c,
            ShapeConfig("train", T, B, "train"), phases=TRAIN_PHASES)
        numbers[remat]["trace"] = {k: trace[k] for k in (
            "wall_ms", "busy_ms", "idle_share", "by_phase")}
        print(f"[30b] yi-6b full width, {L} layers, B={B} T={T}, remat "
              f"{remat}: losses {', '.join(f'{x:.4f}' for x in losses)}; "
              f"step ms {', '.join(f'{x:.1f}' for x in step_ms)}, mean after "
              f"the first {mean_ms:.1f} ms; peak memory {peak} B "
              f"({peak / 2**30:.2f} GiB); launches {run_counts}; {CARD}",
              flush=True)
        check(all(math.isfinite(x) for x in losses),
              f"remat {remat}: non-finite losses {losses}")
        # the flash forward runs again in the backward under both policies
        per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                    "flash_attention_bwd_dkv": L, **NO_SCAN}
        check(run_counts == {k: DOTS_STEPS * n for k, n in per_step.items()},
              f"remat {remat}: launches {run_counts}")
        if remat == "dots":
            counts = run_counts
        del model, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    check(max(abs(a - b) for a, b in zip(numbers["dots"]["losses"],
                                         numbers["full"]["losses"]))
          < DEFAULT_LOSS_TOL,
          f"dots and full train to other losses: {numbers['dots']['losses']}"
          f", {numbers['full']['losses']}")
    print(f"[30b] phase 9 (full, {full_stats['layers']} layers, 6 steps): "
          f"mean {full_stats['mean_step_ms']:.1f} ms, peak "
          f"{full_stats['peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[30b] took {numbers['phase_s']:.1f} s", flush=True)
    return counts, numbers


def sharded_phases() -> tuple:
    """Phases 31 and 31b inside one one-rank NCCL process group, made from
    a ``FileStore`` in a temporary directory and destroyed at the end.
    Returns (phase 31's sharded launch counts, phase 31b's resumed launch
    counts, their numbers)."""
    import contextlib
    import gc
    import math
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.archs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import compressed_psum, init_error
    from repro_torch.sharding import rules as R
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh_for(1, 1, "cuda")
        rules = R.make_rules(mesh)

        def sharded():
            return R.sharding_context(mesh, rules)

        # 31. phase 9's cell on plain tensors, then on DTensors
        L, B, T, steps = TRAIN_LAYERS, 4, 1024, SHARDED_STEPS
        cfg = dataclasses.replace(get_config("yi-6b", "full"), n_layers=L)
        data = SyntheticTokens(cfg, DataConfig(batch=B, seq_len=T))
        opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                    total_steps=steps)
        runs, plain_grads, psum = {}, {}, {}
        for mode in ("plain", "sharded"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            model = Model(cfg, dev, trainable=True).init_weights(0)
            if mode == "sharded":
                train.place_model(model, mesh, rules)
            opt_state = adamw.init_state(dict(model.named_parameters()))
            step = make_train_step(cfg, opt_cfg)
            reset_counts()
            shapes0 = dict(flash_attention.launches_by_shape)
            losses, step_ms = [], []
            for i in range(steps):
                batch = train.to_device(data.batch_at(i), dev)
                if mode == "sharded":
                    batch = train.place_batch(batch, mesh, rules)
                torch.cuda.synchronize()
                ts = time.perf_counter()
                with sharded() if mode == "sharded" else \
                        contextlib.nullcontext():
                    losses.append(float(step(model, opt_state, batch)["loss"]))
                step_ms.append((time.perf_counter() - ts) * 1e3)
                if i == 0 and mode == "plain":
                    plain_grads = {n: p.grad.to("cpu") for n, p in
                                   model.named_parameters()}
                if i == 0 and mode == "sharded":
                    worst, same = 0.0, True
                    for n, p in model.named_parameters():
                        g, want = R.unshard(p.grad), plain_grads[n].to(dev)
                        worst = max(worst, rel_err(g, want))
                        same = same and torch.equal(g, want)
                        del g, want
            peak = torch.cuda.max_memory_allocated(dev)
            counts = read_counts()
            by_shape = {k: n - shapes0[k] for k, n in
                        flash_attention.launches_by_shape.items()
                        if n != shapes0[k]}
            mean_ms = sum(step_ms[1:]) / (steps - 1)
            runs[mode] = {"losses": losses, "step_ms": step_ms,
                          "mean_step_ms": mean_ms,
                          "tokens_per_s": B * T / (mean_ms / 1e3),
                          "peak_memory_bytes": peak, "launches": counts,
                          "launches_by_shape": by_shape}
            print(f"[31] yi-6b full width, {L} layers, B={B} T={T}, {mode}"
                  f"{' (DTensor on a (1,1) NCCL mesh)' if mode == 'sharded' else ''}"
                  f": losses {', '.join(f'{x:.6f}' for x in losses)}; step "
                  f"ms {', '.join(f'{x:.1f}' for x in step_ms)}, mean after "
                  f"the first {mean_ms:.1f} ms; peak memory {peak} B; "
                  f"launches {counts}, by shape {by_shape}; {CARD}",
                  flush=True)
            check(all(math.isfinite(x) for x in losses),
                  f"phase 31 {mode}: non-finite losses {losses}")
            if mode == "plain":
                # 31b. compressed_psum at world size 1 over these gradients
                del opt_state
                gc.collect()
                grads = {n: p.grad for n, p in model.named_parameters()}
                reduced, errors = compressed_psum(grads, init_error(grads))
                worst_q, worst_r = 0.0, 0.0
                for n, g in grads.items():
                    y = g.float()
                    step_q = float(y.abs().max()) / 127
                    worst_q = max(worst_q, float(
                        (reduced[n] - y).abs().max()) / max(step_q, 1e-30))
                    # the error buffer is the residual y - q*scale, to the
                    # rounding of q*scale in reduced
                    resid = (y.double() - reduced[n].double()
                             - errors[n].double()).abs().max()
                    worst_r = max(worst_r, float(resid) / max(float(
                        reduced[n].abs().max()), 1e-30))
                psum = {"max_err_in_steps": worst_q,
                        "residual_rel_err": worst_r,
                        "tensors": len(grads),
                        "elements": sum(g.numel() for g in grads.values())}
                del grads, reduced, errors
                print(f"[31b] compressed_psum at world size 1 over yi-6b's "
                      f"{psum['tensors']} gradients ({psum['elements']:,} "
                      f"elements): largest |reduced - g| "
                      f"{worst_q:.6f} quantization steps (<= 0.5, and the "
                      f"rounding of q*scale); error buffer minus the "
                      f"residual at most {worst_r:.3e} of max|reduced| (<= "
                      f"2^-23); {CARD}", flush=True)
                check(worst_q <= 0.5 + 1e-4,
                      "compressed_psum at world size 1 is not the identity")
                check(worst_r <= 2.0 ** -23,
                      "the error buffer is not the residual")
            del model, batch
        gc.collect()
        torch.cuda.empty_cache()
        a, b = runs["plain"], runs["sharded"]
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                           a["losses"]))
        numbers = {"layers": L, "batch": B, "seq": T, "steps": steps,
                   "plain": a, "sharded": b, "loss_rel_err": loss_err,
                   "grad_rel_err": worst, "grads_bit_identical": same,
                   "dtensor_host_ms": b["mean_step_ms"] - a["mean_step_ms"],
                   "compressed_psum": psum}
        print(f"[31] sharded vs plain: losses max rel err {loss_err:.3e}, "
              f"first-step gradients max|err|/max|ref| {worst:.3e} (< "
              f"{SHARDED_TOL:g}), bit-identical {same}; mean step "
              f"{b['mean_step_ms']:.1f} ms sharded against "
              f"{a['mean_step_ms']:.1f} ms plain ({b['mean_step_ms'] - a['mean_step_ms']:+.1f} "
              f"ms of DTensor host work); {CARD}", flush=True)
        check(loss_err < SHARDED_TOL and worst < SHARDED_TOL,
              "the sharded step disagrees with the plain one")
        check(a["launches"] == b["launches"]
              and a["launches_by_shape"] == b["launches_by_shape"]
              and b["launches_by_shape"] == {
                  "fwd/128/causal": 2 * L * steps,
                  "dq/128/causal": L * steps, "dkv/128/causal": L * steps},
              f"sharded launches {b['launches']} {b['launches_by_shape']}, "
              f"plain {a['launches']} {a['launches_by_shape']}")

        # 31b. a checkpoint of the plain launcher resumed on the mesh
        RB, RT, RS = RESUME_RUN
        args = ["--preset", "smoke", "--batch", str(RB), "--seq", str(RT)]
        unbroken, _ = train.main(args + ["--steps", str(RS)])
        ckpt_dir = os.path.join(tmp, "ckpt")
        saved, _ = train.main(args + ["--steps", "2", "--ckpt-dir",
                                      ckpt_dir])
        start, host_state, _ = CheckpointManager(ckpt_dir).restore()
        scfg = get_config("yi-6b", "smoke")
        model = train.place_model(
            Model(scfg, dev, trainable=True).init_weights(1), mesh, rules)
        params = dict(model.named_parameters())
        opt_state = adamw.init_state(params)
        state = reshard_state(scfg, host_state, mesh)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(state["params"][n])
                for key in ("m", "v"):
                    opt_state[key][n].copy_(state["opt_state"][key][n])
        opt_state["step"] = state["opt_state"]["step"]
        step = make_train_step(scfg, adamw.AdamWConfig(
            lr=3e-4, warmup_steps=max(2, RS // 10), total_steps=RS))
        rdata = SyntheticTokens(scfg, DataConfig(batch=RB, seq_len=RT))
        reset_counts()
        resumed = []
        for i in range(start, RS):
            batch = train.place_batch(train.to_device(rdata.batch_at(i), dev),
                                      mesh, rules)
            with sharded():
                resumed.append(float(step(model, opt_state, batch)["loss"]))
        resume_counts = read_counts()
        resume_err = max(abs(x - y) / abs(y) for x, y in
                         zip(saved + resumed, unbroken))
        numbers["resume"] = {"unbroken": unbroken, "saved": saved,
                             "resumed": resumed, "from_step": start,
                             "loss_rel_err": resume_err,
                             "launches": resume_counts}
        print(f"[31b] yi-6b smoke, B={RB} T={RT}: saved at step {start} by "
              f"the plain launcher ({', '.join(f'{x:.6f}' for x in saved)}), "
              f"resumed through reshard_state on the (1,1) mesh: "
              f"{', '.join(f'{x:.6f}' for x in resumed)}; unbroken "
              f"{', '.join(f'{x:.6f}' for x in unbroken)}; max rel err "
              f"{resume_err:.3e} (< {SHARDED_TOL:g}); launches "
              f"{resume_counts}; {CARD}", flush=True)
        check(start == 2 and len(resumed) == RS - 2
              and resume_err < SHARDED_TOL,
              "the resumed run does not continue the unbroken one")
        check(resume_counts["flash_attention_fwd"] == 2 * scfg.n_layers
              * (RS - 2), f"resumed launches {resume_counts}")
        del model, params, opt_state, state, host_state
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[31] phases 31-31b took {numbers['phase_s']:.1f} s", flush=True)
    return runs["sharded"]["launches"], resume_counts, numbers


def examples_phase() -> tuple:
    """Phase 32: the ported examples on the card, in this process: the
    quickstart (8 steps of the smoke preset, head dim 16) and the
    end-to-end driver's tiny preset (300 steps, head dim 64, checkpoints
    in a temporary directory). Returns ({example: launch counts}, their
    numbers)."""
    import importlib.util
    import math
    import tempfile

    t0 = time.perf_counter()

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    counts, numbers = {}, {}
    reset_counts()
    losses = load("quickstart_torch").main([])
    counts["quickstart"] = read_counts()
    numbers["quickstart"] = {"losses": losses}
    print(f"[32] examples/quickstart_torch.py on the card: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches "
          f"{counts['quickstart']}; {CARD}", flush=True)
    check(len(losses) == 8 and all(math.isfinite(x) for x in losses),
          f"quickstart losses {losses}")
    check(counts["quickstart"]["flash_attention_fwd"] == 2 * 8,
          f"quickstart launches {counts['quickstart']}")
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        losses, stats = load("train_e2e_torch").main(["--ckpt-dir", d])
        counts["train_e2e"] = read_counts()
    numbers["train_e2e"] = {"first_loss": losses[0], "last_loss": losses[-1],
                            "steps": len(losses),
                            "mean_step_ms": stats["mean_step_ms"],
                            "launches_by_shape": stats["launches_by_shape"][0]}
    print(f"[32] examples/train_e2e_torch.py tiny on the card: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps, "
          f"mean step {stats['mean_step_ms']:.1f} ms; launches "
          f"{counts['train_e2e']}, by shape each step "
          f"{stats['launches_by_shape'][0]}; {CARD}", flush=True)
    check(len(losses) == 300 and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] - 0.1, "train_e2e did not train")
    check(stats["launches_by_shape"][0] == {
        "fwd/64/causal": 8, "dq/64/causal": 4, "dkv/64/causal": 4},
        f"train_e2e launches {stats['launches_by_shape'][0]}")
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[32] took {numbers['phase_s']:.1f} s", flush=True)
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


def scan_sass(lib, exact=None) -> str:
    """Count, in the SASS of every scan kernel in library ``lib``
    (``cuobjdump -sass``), the special-function (MUFU) instructions and
    the MUFU.EX2 among them; fail unless each kernel's are all EX2 and a
    multiple of four (one a state, four states a lane and a step) or,
    where ``exact`` is given, exactly that many in each kernel."""
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
             and ex2 == (exact or ex2) for mufu, ex2 in counts.values())
    summary = sorted({f"{mufu} MUFU, {ex2} MUFU.EX2"
                      for mufu, ex2 in counts.values()})
    want = (f"{exact} expected: one a state, 4 states a lane, "
            f"{exact // 4} unrolled steps" if exact else
            "four EX2 a step body: one a state")
    print(f"    {lib.name} SASS, {len(counts)} kernels: "
          f"{'; '.join(summary)} a kernel ({want})", flush=True)
    check(ok, f"scan SASS: a MUFU other than EX2, or EX2 not one a state: "
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
        for D in kernel.HEAD_DIMS[name]:
            smem, blocks = kernel.wgmma_info(name, D)
            reports[f"{name} wgmma D={D} smem"] = (
                f"{smem} B dynamic shared memory, {blocks} blocks an SM")
            print(f"    {name} wgmma D={D}: {smem} B dynamic shared memory, "
                  f"{blocks} blocks an SM", flush=True)
    for x_dt, p_dt in ((torch.bfloat16, torch.float32),
                       (torch.float32, torch.float32),
                       (torch.bfloat16, torch.bfloat16)):
        for N in scan_kernel.STATE_SIZES:
            for kind, backward in (("scan", False), ("scan bwd", True)):
                smem, blocks = scan_kernel.selective_scan_info(
                    N, x_dt, p_dt, backward=backward)
                label = (f"{kind} x {str(x_dt)[6:]}, dt/B/C "
                         f"{str(p_dt)[6:]}, N={N}")
                warps = blocks * scan_kernel.CHANNELS * N // 4 // 32
                reports[f"{label} smem"] = (
                    f"{smem} B dynamic shared memory, {blocks} blocks an SM")
                reports[f"{label} occupancy"] = (smem, blocks, warps)
                print(f"    {label}: {smem} B dynamic shared memory, "
                      f"{blocks} blocks ({warps} warps) an SM", flush=True)
    reports["scan sass"] = scan_sass(libs["selective_scan"])
    # the backward: one ex2 a state of the recompute's unrolled sub-tile,
    # none in the walk
    reports["scan bwd sass"] = scan_sass(libs["selective_scan_bwd"],
                                         4 * scan_kernel.SAVE_EVERY)
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

    global T0
    T0 = time.perf_counter()
    setup()
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_decode_step, make_prefill_step

    dev = torch.device("cuda")

    # 1. the card
    kind, count, card, sms, clock_hz = card_info()
    global CARD
    CARD = card
    print(f"[1] device: {kind} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {sms} SMs, top SM clock "
          f"{clock_hz / 1e6:.0f} MHz")
    print(card, flush=True)

    # 2. build, one nvcc per source, all started together
    reports = build_phase()

    # 3. one wgmma product against torch.matmul, then the kernel against
    # its plain version on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    for D in kernel.HEAD_DIMS["fwd"]:
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

    # 21. the forward at head dim 256, gemma3's prefill shape
    d256 = d256_phase(reports)
    # 25. the backward at head dim 256, gemma3's training shape
    d256_bwd = d256_backward_phase(reports)

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
    print(f"[5] decode step ms: min {dec['min_ms']:.2f}, max "
          f"{dec['max_ms']:.2f}, mean {dec['mean_ms']:.2f} over {G} steps, "
          f"captured {dec['captured']}")
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
    tokens_5b = tokens
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
    del caches, token

    # 23. captured against eager decode on this model, in turns, and the
    # decode trace of 18 retaken on the captured step
    yi_decode = captured_vs_eager(
        "23", f"yi-6b (32 layers, B={B} P={P} G={G})", model, prompts, G)
    yi_decode.pop("stats")
    check(torch.equal(yi_decode.pop("tokens"), tokens_5b.cpu()),
          "phase 23's yi-6b tokens differ from phase 5's")
    serve_trace["decode_captured"] = captured_trace(
        f"yi-6b decode step (32 layers, B={B}, position {P})", model,
        prompts, full)
    del model, prompts
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
    gemma_counts, gemma = gemma3_phase()
    xlstm_numbers = xlstm_phase()
    gemma_train_counts, gemma_train = gemma3_train_phase()
    train_paths, moe_xlstm_train = moe_xlstm_train_phase()
    scan_bwd = scan_backward_phase(sms, clock_hz, reports)
    jamba_train_counts, jamba_train = jamba_train_phase()
    vlm_counts, vlm_train = vlm_train_phase()
    cross = attention_shape_phase("29b", "cross shape", CROSS_ATTENTION)
    audio_counts, audio_train = audio_train_phase()
    audio_attention = attention_shape_phase("30", "musicgen's shape",
                                            AUDIO_ATTENTION)
    dots_counts, dots = dots_phase(train_stats)
    sharded_counts, resume_counts, sharded = sharded_phases()
    example_counts, examples = examples_phase()
    default_counts = default_commands_phase()
    d16 = d16_timing_phase(qkv)
    halo_counts, halo = halo_phase()

    print(f"[14] phases 1-32 took {time.perf_counter() - T0:.1f} s",
          flush=True)

    # 14. result lines; gemma3's training counts go to the D = 256 rows,
    # granite's and musicgen's (head dim 64) to the D = 64 rows, the vlm's
    # non-causal ones to the cross rows, the default commands' flash
    # launches to the D = 16 rows: each row's launches were timed at its
    # shape
    vlm_run = vlm_train["launches_by_shape_run"]
    vlm_by_mask = {mask: dict(vlm_counts, **{
        name: vlm_run.get(f"{part}/128/{mask}", 0)
        for part, name, _, _ in FLASH_PARTS}) for mask in ("causal",
                                                           "non-causal")}
    d64_paths = {"train_granite": train_paths.pop("train_granite"),
                 "train_audio": audio_counts,
                 "train_e2e_example": example_counts["train_e2e"]}
    paths = {"serve": serve_counts, "train": train_counts,
             "serve_jamba": jamba_counts, **default_counts,
             "halo": halo_counts, "serve_telemetry": telemetry_counts,
             "train_jamba": jamba_train_counts, **train_paths,
             "train_vlm": vlm_by_mask["causal"], "train_dots": dots_counts,
             "train_sharded": sharded_counts,
             "train_sharded_resumed": resume_counts,
             "quickstart_example": example_counts["quickstart"]}

    d16_paths = ("serve_default", "serve_jamba_default", "train_default",
                 "train_jamba_default", "train_sharded_resumed",
                 "quickstart_example")

    def launches_of(name):
        by_path = {p: c[name] for p, c in paths.items()
                   if not (name.startswith("flash") and p in d16_paths)}
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
    for part, name, replaces, source in FLASH_PARTS:
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
    # head dim 256, on gemma3's prefill: its windowed layers' timing is the
    # row's, the causal (global) layer's beside it
    win, glob = d256["bfloat16 window"], d256["bfloat16 causal"]
    kernels.append({
        "name": "flash_attention_fwd[D=256]",
        "route": "cuda",
        "design": "wgmma, m64n256k16 P V, 2-stage ring",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": gemma_counts["flash_attention_fwd"],
        "launches_by_path": {"serve_gemma3": gemma_counts[
            "flash_attention_fwd"]},
        "max_abs_err": win["max_abs_err"],
        "lse_max_abs_err": win["lse_max_abs_err"],
        "ms": win["ms"],
        "ms_again": win["ms_again"],
        "plain_ms": win["plain_ms"],
        "bound_ms": win["bound_ms"],
        "bound_by": win["bound_by"],
        "library_ms": win["library_ms"],
        "library_backend": win["library_backend"],
        "causal": {k: glob[k] for k in (
            "max_abs_err", "ms", "ms_again", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_backend")},
        "f32": {k: {x: d256[k][x] for x in ("max_abs_err", "ms")}
                for k in ("float32 causal", "float32 window")},
        "ptxas": reports.get("flash_fwd_wgmma_kernel<256>"),
        "ptxas_f32": reports.get("flash_fwd_f32_kernel<256>"),
        "smem": reports.get("fwd wgmma D=256 smem"),
        "shape": "B=4 T=2048 H=16 K=8 D=256 bf16 causal, window 1024",
        "card": card,
    })
    # head dim 256 in the backward, on gemma3's training: its windowed
    # layers' timing is the row's, the causal (global) layer's beside it
    for part, replaces in (("dq", TPU_DQ), ("dkv", TPU_DKV)):
        name = f"flash_attention_bwd_{part}"
        win = d256_bwd["bfloat16 window"]
        glob = d256_bwd["bfloat16 causal"]
        kernels.append({
            "name": f"{name}[D=256]",
            "route": "cuda",
            "design": ("wgmma, one warpgroup on 64 rows, m64n256k16 dS K, "
                       "2-stage ring" if part == "dq" else
                       "wgmma, two warpgroups each owning half of dK and "
                       "dV, S^T and dP^T exchanged in shared memory"),
            "source": BWD_SOURCE,
            "replaces": replaces,
            "launches": gemma_train_counts[name],
            "launches_by_path": {"train_gemma3": gemma_train_counts[name]},
            "max_abs_err": win[part],
            "rel_err": win[f"{part}_rel"],
            "ms": win[f"{part}_ms"],
            "ms_again": win[f"{part}_ms_again"],
            "plain_ms": win["plain_ms"],
            "bound_ms": win[f"{part}_bound_ms"],
            "bound_by": win[f"{part}_bound_by"],
            "library_ms": win["library_ms"],
            "library_backend": win["library_backend"],
            "causal": {k: glob[k] for k in (
                part, f"{part}_rel", f"{part}_ms", f"{part}_ms_again",
                "plain_ms", f"{part}_bound_ms", f"{part}_bound_by",
                "library_ms", "library_backend")},
            "f32": {k: {x: d256_bwd[k][x] for x in (part, f"{part}_ms")}
                    for k in ("float32 causal", "float32 window")},
            "dq_bit_identical": glob["dq_bit_identical"],
            "ptxas": reports.get(f"flash_bwd_{part}_wgmma_kernel<256>"),
            "ptxas_f32": reports.get(f"flash_bwd_{part}_f32_kernel<256>"),
            "smem": reports.get(f"{part} wgmma D=256 smem"),
            "shape": "B=2 T=2048 H=16 K=8 D=256 bf16 window 1024, causal",
            "card": card,
        })
    # the cross-attention's shape, on the vlm training path (its
    # non-causal launches), and head dim 64 on granite's and musicgen's
    for suffix, res, D, row_paths in (
            ("cross", cross, 128,
             {"train_vlm": vlm_by_mask["non-causal"]}),
            ("D=64", audio_attention, 64, d64_paths)):
        for part, name, replaces, source in FLASH_PARTS:
            t = res["timing"][part]
            by_path = {p: c[name] for p, c in row_paths.items()}
            kernels.append({
                "name": f"{name}[{suffix}]",
                "route": "cuda",
                "design": DESIGN[name],
                "source": source,
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": res["max_abs_err"][part],
                "ms": t["ms"],
                "ms_again": t["ms_again"],
                "plain_ms": res["plain_ms"]["fwd" if part == "fwd"
                                            else "bwd"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": res["library_ms"]["fwd" if part == "fwd"
                                                else "bwd"],
                "library_backend": res["library_backend"],
                "ptxas": reports.get(
                    f"{'flash_fwd' if part == 'fwd' else 'flash_bwd_' + part}"
                    f"_wgmma_kernel<{D}>"),
                "shape": res["shape"],
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
    total, by_path = launches_of("selective_scan_bwd")
    t = scan_bwd["timing"]
    kernels.append({
        "name": "selective_scan_bwd",
        "route": "cuda",
        "design": DESIGN["selective_scan_bwd"],
        "source": SCAN_BWD_SOURCE,
        "replaces": TPU_SCAN_BWD,
        "launches": total,
        "launches_by_path": by_path,
        "max_abs_err": max(g["max_abs_err"] for g in
                           scan_bwd["serving"]["grads"].values()),
        "rel_err": {n: g["rel_err"] for n, g in
                    scan_bwd["serving"]["grads"].items()},
        "bit_identical": scan_bwd["serving"]["bit_identical"],
        "ms": t["ms"],
        "ms_again": t["ms_again"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "ptxas": t["ptxas"],
        "smem": t["smem"],
        "blocks_per_sm": t["blocks_per_sm"],
        "warps_per_sm": t["warps_per_sm"],
        "sass": t["sass"],
        "saved_state_bytes": t["saved_state_bytes"],
        "saved_bytes_beyond_bound": t["saved_bytes_beyond_bound"],
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
                      "serve_gemma3": gemma,
                      "serve_xlstm": xlstm_numbers,
                      "train_gemma3": gemma_train,
                      "train_moe_xlstm": moe_xlstm_train,
                      "train_jamba": jamba_train,
                      "train_vlm": vlm_train,
                      "train_audio": audio_train,
                      "cross_attention": cross,
                      "audio_attention": audio_attention,
                      "remat_dots": dots,
                      "train_sharded": sharded,
                      "examples": examples,
                      "scan_backward": {k: v for k, v in scan_bwd.items()
                                        if k != "timing"},
                      "captured_vs_eager_yi6b": yi_decode,
                      "card": card,
                      "seconds": time.perf_counter() - T0,
                      "device_traces": {"train": train_trace,
                                        "train_gemma3": gemma_train.pop(
                                            "trace"),
                                        "train_jamba": jamba_train.pop(
                                            "trace"),
                                        "train_vlm": vlm_train.pop("trace"),
                                        "train_audio": audio_train.pop(
                                            "trace"),
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
