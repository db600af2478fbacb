"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --preset full --layers 8 --batch 4 --seq 1024 --steps 6

Every family the reference trains: dense (yi-6b, ...), sliding windows
and head dim 256 (gemma3-12b), MoE (granite-moe-3b-a800m,
deepseek-moe-16b), xLSTM (xlstm-125m), the mamba/attention/MoE hybrid
(jamba-v0.1-52b), gated cross-attention over encoder embeddings
(llama-3.2-vision-11b) and frame input with 4 codebooks
(musicgen-large). ``--layers`` rounds down to whole pattern groups.

Wires the port's pieces together: config -> mesh -> f32 master weights
placed by the sharding rules -> profiled train loop -> async checkpoints ->
straggler detector -> trace export. Runs on the CUDA card unless
``--device cpu`` is given; with no card and no ``--device cpu`` it raises.

Across ranks: when the default process group is initialised (by the
caller, as a test does from a ``FileStore``, or from ``torchrun``'s
environment when run as ``python -m``), its world size is the device
count, and the launcher builds the (data, model) ``DeviceMesh`` of
``--model-parallel``, places the weights and the AdamW state by the rules
as DTensors, gives every rank the global batch distributed over
``"batch"``, and resumes a checkpoint through ``reshard_state`` on the new
mesh. One rank with ``--model-parallel 1`` keeps plain tensors. A
``--model-parallel`` that does not divide the world raises ``ValueError``;
so does a family that DTensor does not carry yet (MoE, xLSTM, mamba, the
vlm and audio models) on a mesh of more than one rank.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --model-parallel 2 --steps 4 --batch 4 --seq 64 Weights are random, made from
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
import contextlib
import dataclasses
import os
import sys
import time
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import distribute_tensor

from ..checkpoint.elastic import reshard_state
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
from ..models import model as M
from ..models.model import Model
from ..optim import adamw
from ..sharding import rules as R
from ..train.step import make_train_step
from .mesh import make_mesh_for, mesh_for_shape

_UNSHARDED = "ROADMAP Queue 1, item 9: the families DTensor does not carry yet"


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


def check_shardable(cfg) -> None:
    """Raise ValueError for a model that DTensor does not carry yet on a
    mesh of more than one rank, naming what stops it."""
    why = []
    if cfg.input_mode == "frames":
        why.append("frame input (audio)")
    for spec in cfg.pattern:
        if spec.ffn == "moe":
            why.append("MoE routing's scatters")
        if spec.mixer in ("mlstm", "slstm"):
            why.append("the xLSTM loops")
        if spec.mixer == "mamba":
            why.append("the selective scan's channels")
        if spec.cross_attn:
            why.append("cross-attention (vlm)")
    if why:
        raise ValueError(f"{cfg.name} does not train on a mesh yet "
                         f"({', '.join(sorted(set(why)))}): {_UNSHARDED}")


def place_model(model: Model, mesh, rules: Dict[str, Any]) -> Model:
    """Replace every parameter of ``model`` by a DTensor on ``mesh``:
    ``distribute_tensor`` under ``tree_shardings`` of its param specs."""
    cfg = model.cfg
    shardings = R.tree_shardings(M.param_axes(cfg), mesh, rules,
                                 M.param_shapes(cfg))
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        module.register_parameter(leaf, nn.Parameter(
            distribute_tensor(p.detach(), mesh, shardings[name]),
            requires_grad=p.requires_grad))
    return model


def place_batch(batch: Dict[str, torch.Tensor], mesh, rules: Dict[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """The global ``batch`` (the same on every rank) distributed over the
    batch axes (``batch_shardings``)."""
    sh = R.batch_shardings(batch, mesh, rules)
    return {k: distribute_tensor(v, mesh, sh[k]) for k, v in batch.items()}


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
                    help="width of the mesh's model axis; it divides the "
                         "process group's world size")
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M-param e2e run)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh_for_shape(world, args.model_parallel)     # ValueError if indivisible

    device = resolve_device(args.device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    say = print if rank == 0 else (lambda *a, **k: None)
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

    mesh = rules = None
    if world > 1:
        check_shardable(cfg)
        mesh = make_mesh_for(world, args.model_parallel, device.type)
        rules = R.make_rules(mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = Model(cfg, device, trainable=True).init_weights(0)
    if mesh is not None:
        place_model(model, mesh, rules)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"arch={cfg.name} preset={args.preset} device={device} "
        f"layers={cfg.n_layers}"
        + (f" mesh={R.axis_sizes(mesh)}" if mesh is not None else ""))
    say(f"params: {n_params:,}")

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
            if mesh is not None:
                # the unsharded state re-placed on this run's mesh
                host_state = reshard_state(cfg, host_state, mesh)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(host_state["params"][name])
                for key in ("m", "v"):
                    for name, t in opt_state[key].items():
                        t.copy_(host_state["opt_state"][key][name])
            opt_state["step"] = int(host_state["opt_state"]["step"])
            say(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)

    def sharded():
        return (R.sharding_context(mesh, rules) if mesh is not None
                else contextlib.nullcontext())

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
                if mesh is not None:
                    batch = place_batch(batch, mesh, rules)
            before = _launch_counts()
            before_v = dict(flash_attention.launches_by_variant)
            before_s = dict(flash_attention.launches_by_shape)
            t0 = time.perf_counter()
            with regions.annotate("train/compute", category="api"), sharded():
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
            say(f"step {step:5d} loss {loss:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt * 1e3:.0f} ms)")
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt_state": opt_state})
        ckpt.wait()
        ckpt.close()

    events = global_collector().drain()
    gf = GraphFrame.from_events(events)
    say("\nprofile (inclusive seconds):")
    say(gf.tree(metric="sum", fmt="{:.3f}", max_depth=2))
    if args.trace_out:
        timeline.save_trace(timeline.to_chrome_trace(events), args.trace_out)
        say(f"chrome trace -> {args.trace_out}")
    if detector.flagged:
        say("straggler findings:",
              *[str(f) for f in detector.flagged], sep="\n  ")
    if losses:
        say(f"\nfinal loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    steady = step_ms[1:] or step_ms
    mean_ms = sum(steady) / len(steady) if steady else float("nan")
    stats = {
        "device": str(device),
        "mesh": R.axis_sizes(mesh) if mesh is not None else None,
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


def _main_from_env(argv=None):
    """``python -m`` entry. Under ``torchrun`` (``WORLD_SIZE`` > 1 in the
    environment) it first initialises the default process group from the
    environment, NCCL on the cards and gloo with ``--device cpu``, and
    destroys it at the end."""
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return main(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    on_cpu = torch.device(pre.parse_known_args(argv)[0].device).type == "cpu"
    dist.init_process_group("gloo" if on_cpu else "nccl")
    try:
        return main(argv)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main_from_env(sys.argv[1:])
