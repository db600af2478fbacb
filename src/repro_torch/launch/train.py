"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --preset full --layers 8 --batch 4 --seq 1024 --steps 6

Every family the reference trains: dense (yi-6b, ...), sliding windows
and head dim 256 (gemma3-12b), MoE (granite-moe-3b-a800m,
deepseek-moe-16b), xLSTM (xlstm-125m), the mamba/attention/MoE hybrid
(jamba-v0.1-52b), gated cross-attention over encoder embeddings
(llama-3.2-vision-11b) and frame input with 4 codebooks
(musicgen-large). ``--layers`` rounds down to whole pattern groups.

Wires the port's pieces together: config -> f32 master weights on one
device -> profiled train loop -> async checkpoints -> straggler detector ->
trace export. Runs on the CUDA card unless ``--device cpu`` is given; with
no card and no ``--device cpu`` it raises. Weights are random, made from
seed 0; the data is the synthetic bigram stream (random frames and
encoder embeddings beside it, for the families that take them).
Attention runs the CUDA flash-attention forward and, in the backward, the
dq and dk/dv kernels; a mamba layer the selective-scan forward and its
backward kernel. ``stats`` counts their launches each step by kernel
(flash attention also by variant, and by head dim and mask: causal or
not), and holds each step's MoE aux loss and load balance.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Tuple

import torch

from ..checkpoint.manager import CheckpointManager
from ..checkpoint.straggler import StragglerDetector
from ..configs.archs import get_config
from ..core import regions, timeline
from ..core.collector import global_collector, reset_global_collector
from ..core.graphframe import GraphFrame
from ..data.pipeline import DataConfig, SyntheticTokens
from ..device import resolve_device
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.mamba_scan.ops import selective_scan
from ..models.model import Model
from ..optim import adamw
from ..train.step import make_train_step

_SHARDING = ("ROADMAP Queue 1, modules still missing (the mesh-sharding "
             "layer)")


def _launch_counts() -> Dict[str, int]:
    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention.bwd_dq_launches,
            "flash_attention_bwd_dkv": flash_attention.bwd_dkv_launches,
            "selective_scan": selective_scan.launches,
            "selective_scan_bwd": selective_scan.bwd_launches}


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``: integer arrays (tokens, labels) as
    int64, float arrays (frames, encoder embeddings) as f32; the model
    casts those to its compute dtype, as the JAX package does."""
    return {k: torch.from_numpy(v).to(
        device, torch.long if v.dtype.kind in "iu" else torch.float32)
        for k, v in batch.items()}


def main(argv=None) -> Tuple[List[float], Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="only 1: sharding is not ported yet")
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M-param e2e run)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        ap.error(f"--model-parallel {args.model_parallel}: sharding is not "
                 f"ported yet ({_SHARDING}); the port trains on one device")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, args.preset)
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model,
            d_ff=args.d_model * 4 if cfg.d_ff else 0,
            n_heads=max(4, args.d_model // 64),
            n_kv_heads=max(4, args.d_model // 64), d_head=64)
    if args.layers:
        plen = len(cfg.pattern)
        cfg = dataclasses.replace(
            cfg, n_layers=max(plen, args.layers // plen * plen))
    # MiniCPM trains with WSD per its paper
    schedule = "wsd" if cfg.name.startswith("minicpm") else args.schedule

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = Model(cfg, device, trainable=True).init_weights(0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} preset={args.preset} device={device} "
          f"layers={cfg.n_layers}")
    print(f"params: {n_params:,}")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, schedule=schedule,
                                warmup_steps=max(2, args.steps // 10),
                                total_steps=args.steps)
    data = SyntheticTokens(cfg, DataConfig(batch=args.batch, seq_len=args.seq))

    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    start_step = 0
    params = dict(model.named_parameters())
    opt_state = adamw.init_state(params)
    if ckpt and args.resume:
        restored = ckpt.restore()
        if restored:
            start_step, host_state, _ = restored
            # one device: the state loads as saved (an elastic re-mesh,
            # checkpoint/elastic.reshard_state, waits for sharding)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(host_state["params"][name])
                for key in ("m", "v"):
                    for name, t in opt_state[key].items():
                        t.copy_(host_state["opt_state"][key][name])
            opt_state["step"] = int(host_state["opt_state"]["step"])
            print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)
    detector = StragglerDetector()
    reset_global_collector()
    losses: List[float] = []
    step_ms: List[float] = []
    launches: List[Dict[str, int]] = []
    by_variant: List[Dict[str, int]] = []
    by_shape: List[Dict[str, int]] = []
    moe_aux: List[float] = []
    moe_load_balance: List[float] = []
    for step in range(start_step, args.steps):
        with regions.annotate("train/step", category="app", step=step):
            with regions.annotate("train/data", category="data"):
                batch = to_device(data.batch_at(step), device)
            before = _launch_counts()
            before_v = dict(flash_attention.launches_by_variant)
            before_s = dict(flash_attention.launches_by_shape)
            t0 = time.perf_counter()
            with regions.annotate("train/compute", category="api"):
                metrics = step_fn(model, opt_state, batch)
                loss = float(metrics["loss"])      # waits for the device
            dt = time.perf_counter() - t0
            after = _launch_counts()
            launches.append({k: after[k] - before[k] for k in after})
            by_variant.append({k: n - before_v[k] for k, n in
                               flash_attention.launches_by_variant.items()})
            by_shape.append({k: n - before_s[k] for k, n in
                             flash_attention.launches_by_shape.items()
                             if n != before_s[k]})
            moe_aux.append(float(metrics["moe_aux"]))
            moe_load_balance.append(float(metrics["moe_load_balance"]))
            detector.record(rank=0, step=step, duration_s=dt)
            losses.append(loss)
            step_ms.append(dt * 1e3)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                with regions.annotate("train/checkpoint", category="runtime"):
                    ckpt.save(step + 1, {"params": params,
                                         "opt_state": opt_state})
        if step < start_step + 3 or (step + 1) % 10 == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt * 1e3:.0f} ms)")
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt_state": opt_state})
        ckpt.wait()
        ckpt.close()

    events = global_collector().drain()
    gf = GraphFrame.from_events(events)
    print("\nprofile (inclusive seconds):")
    print(gf.tree(metric="sum", fmt="{:.3f}", max_depth=2))
    if args.trace_out:
        timeline.save_trace(timeline.to_chrome_trace(events), args.trace_out)
        print(f"chrome trace -> {args.trace_out}")
    if detector.flagged:
        print("straggler findings:",
              *[str(f) for f in detector.flagged], sep="\n  ")
    if losses:
        print(f"\nfinal loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    steady = step_ms[1:] or step_ms
    mean_ms = sum(steady) / len(steady) if steady else float("nan")
    stats = {
        "device": str(device),
        "params": n_params,
        "layers": cfg.n_layers,
        "step_ms": step_ms,
        "mean_step_ms": mean_ms,
        "tokens_per_s": args.batch * args.seq / (mean_ms / 1e3),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "launches": launches,
        "launches_by_variant": by_variant,
        "launches_by_shape": by_shape,
        "moe_aux": moe_aux,
        "moe_load_balance": moe_load_balance,
        "tree": gf.to_dict(),
    }
    return losses, stats


if __name__ == "__main__":
    main()
