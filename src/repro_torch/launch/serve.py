"""Batched serving entry point: prefill + greedy decode with profiling
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --preset full --batch 4 --prompt-len 1024 --gen 32

Runs on the CUDA card unless ``--device cpu`` is given; with no card and
no ``--device cpu`` it raises. Weights and prompts are random, made from
``--seed``. Prefill attention runs the CUDA flash-attention kernel, and
a mamba layer's prefill the CUDA selective-scan kernel.

``--telemetry`` serves live telemetry over HTTP/SSE while prefill and
decode run: a :class:`~repro_torch.telemetry.TelemetryBridge` polls the
global counter registry (source ``counters``) and watches the global
region collector (source ``regions``), and a
:class:`~repro_torch.telemetry.TelemetryServer` answers ``/metrics``,
``/findings`` and ``/stream`` on ``127.0.0.1`` (``--telemetry-port``,
ephemeral by default). The bridge's reads are non-destructive, so the
end-of-run region tree still sees every event.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Tuple

import torch

from ..configs.archs import get_config
from ..core import regions
from ..core.collector import global_collector, reset_global_collector
from ..core.counters import global_registry
from ..core.graphframe import GraphFrame
from ..device import resolve_device
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.mamba_scan.ops import selective_scan
from ..models.model import Model
from ..telemetry import TelemetryBridge, TelemetryServer
from ..train.step import make_decode_step, make_prefill_step


# the kernels of the prefill, by name, with their launch counters
PREFILL_KERNELS = {"flash_attention_fwd": flash_attention,
                   "selective_scan": selective_scan}


def _launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in PREFILL_KERNELS.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, gen: int
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill ``prompts`` (B, P), then ``gen`` greedy decode steps.

    Returns the generated tokens (B, gen + 1): the prefill's prediction,
    then one per decode step. The caches are allocated once at P + gen
    slots. Records ``serve/prefill`` and ``serve/decode_step`` regions.
    ``stats["prefill_kernel_launches"]`` counts each kernel's launches in
    the prefill, by name, and ``stats["prefill_launches_by_variant"]`` the
    flash-attention launches by variant (``flash_attention.
    launches_by_variant``); ``stats["prefill_logits"]`` holds the
    prefill's logits (f32, on the CPU).
    """
    cfg, device = model.cfg, model.device
    B, P = prompts.shape
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    caches = model.alloc_cache(B, P + gen)
    launches0 = _launches()
    variants0 = dict(flash_attention.launches_by_variant)
    with torch.no_grad():
        with regions.annotate_torch("serve/prefill", category="api") as box:
            logits = prefill(model, {"tokens": prompts}, caches)
            box["out"] = logits
            _sync(device)
        finite = torch.isfinite(logits).all()
        prefill_logits = logits.float().cpu()
        prefill_launches = {name: n - launches0[name]
                            for name, n in _launches().items()}
        prefill_variants = {
            k: n - variants0[k]
            for k, n in flash_attention.launches_by_variant.items()}
        token = logits[:, 0].argmax(dim=-1).to(torch.int32)[:, None]
        out_tokens = [token]
        t0 = time.perf_counter()
        for t in range(P, P + gen):
            with regions.annotate_torch("serve/decode_step", category="api",
                                        pos=t) as box:
                logits, next_tok = decode(model, caches, {"tokens": token}, t)
                token = next_tok[:, 0][:, None]
                out_tokens.append(token)
                box["out"] = token
            finite &= torch.isfinite(logits).all()
        _sync(device)
        dt = time.perf_counter() - t0
    prefill_ev = [e for e in global_collector().drain()
                  if e.name == "serve/prefill"][-1]
    stats = {
        "device": str(device),
        "prefill_ms": prefill_ev.duration / 1e6,
        "decode_s": dt,
        "decode_tok_s": B * gen / dt if gen else float("nan"),
        "prefill_kernel_launches": prefill_launches,
        "prefill_launches_by_variant": prefill_variants,
        "logits_finite": bool(finite),
        "prefill_logits": prefill_logits,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }
    return torch.cat(out_tokens, dim=1), stats


def main(argv=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (prompts: seed + 1)")
    ap.add_argument("--telemetry", action="store_true",
                    help="serve live counter/region telemetry over "
                         "HTTP/SSE while prefill/decode run")
    ap.add_argument("--telemetry-port", type=int, default=0,
                    help="bind port for --telemetry (default: ephemeral)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, args.preset)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name}: serving demo expects token input")
    B, P, G = args.batch, args.prompt_len, args.gen
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = Model(cfg, device).init_weights(args.seed)
    gen_cpu = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen_cpu
                            ).to(device)

    collector = reset_global_collector()
    bridge = server = None
    if args.telemetry:
        bridge = TelemetryBridge(session=f"serve[{cfg.name}]")
        bridge.watch(global_registry(), name="counters")
        bridge.watch_events(collector, name="regions")
        server = TelemetryServer(bridge, port=args.telemetry_port).start()
        bridge.start()
        print(f"telemetry: {server.url}/metrics | /stream | /findings")
    try:
        gen, stats = generate(model, prompts, G)
        if bridge is not None:
            bridge.stop()
            stats["telemetry"] = {"url": server.url, "polls": bridge.polls,
                                  "deltas_total": bridge.deltas_total,
                                  "findings": bridge.findings_json()}
    finally:
        if bridge is not None:
            server.stop()
            bridge.close()
    print(f"{cfg.name}: prefill {B}x{P}, generated {B}x{G} greedy tokens")
    print(f"prefill: {stats['prefill_ms']:.1f} ms, kernel launches "
          f"{stats['prefill_kernel_launches']}")
    print(f"decode throughput: {stats['decode_tok_s']:.1f} tok/s "
          f"({stats['decode_s'] / max(G, 1) * 1e3:.1f} ms/step)")
    if stats["peak_memory_bytes"] is not None:
        print(f"peak memory allocated: {stats['peak_memory_bytes'] / 2**30:.2f} GiB")
    print("sample:", gen[0, :16].tolist())
    if bridge is not None:
        tel = stats["telemetry"]
        print(f"telemetry: {tel['polls']} polls, {tel['deltas_total']} "
              f"deltas, {len(tel['findings'])} live findings")
    gf = GraphFrame.from_events(global_collector().drain())
    print(gf.tree(metric="sum", fmt="{:.3f}", max_depth=1))
    stats["tree"] = gf.to_dict()
    return gen, stats


if __name__ == "__main__":
    main()
