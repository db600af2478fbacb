"""Batched serving entry point: prefill + greedy decode with profiling
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --preset full --batch 4 --prompt-len 1024 --gen 32

Runs on the CUDA card unless ``--device cpu`` is given; with no card and
no ``--device cpu`` it raises. Weights and prompts are random, made from
``--seed``. Serves every architecture with token input (``--arch``:
yi-6b, jamba-v0.1-52b, gemma3-12b, xlstm-125m, ...; the two with other
inputs are refused, as the reference refuses them). Prefill attention
runs the CUDA flash-attention kernel (windowed on gemma3's local
layers), and a mamba layer's prefill the CUDA selective-scan kernel. On
the card each decode step replays one captured CUDA graph, the
counterpart of the reference's jitted decode over donated caches. A call
is named stretch by stretch in regions: ``serve/alloc_cache``,
``serve/capture`` (on the card), ``serve/prefill``,
``serve/prefill_readback``, ``serve/decode_step`` and ``serve/finish``
(``generate``).

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
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.mamba_scan.ops import selective_scan
from ..models.model import Model
from ..telemetry import TelemetryBridge, TelemetryServer
from ..train.step import (CapturedDecode, make_decode_step,
                          make_prefill_step)


# the kernels of the prefill, by name, with their launch counters
PREFILL_KERNELS = {"flash_attention_fwd": flash_attention,
                   "selective_scan": selective_scan}


def _launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in PREFILL_KERNELS.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, gen: int,
             captured: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill ``prompts`` (B, P), then ``gen`` greedy decode steps.

    Returns the generated tokens (B, gen + 1): the prefill's prediction,
    then one per decode step. The caches are allocated once for P + gen
    positions. On the card decode is one captured CUDA graph replayed at
    every position (:class:`~repro_torch.train.step.CapturedDecode`,
    captured before the prefill), unless ``captured=False`` asks for eager
    decode; on the CPU decode runs eagerly. Prefill runs eagerly.

    Every stretch of a call is a region (:func:`repro_torch.core.regions.
    annotate`: a collector event, and a ``record_function`` span while a
    ``torch.profiler`` runs), in order: ``serve/alloc_cache`` (the
    caches), ``serve/capture`` (building the captured decode step, on the
    card only; its stretches are spans of their own, see
    :class:`~repro_torch.train.step.CapturedDecode`), ``serve/prefill``,
    ``serve/prefill_readback`` (the finiteness check, the logits copied
    to the host, the launch counts, the first token),
    ``serve/decode_step`` at every position (the step, its token and its
    finiteness check) and ``serve/finish`` (the last synchronize, the
    last logits copied to the host, the stats, and the captured graph's
    release). A region reads the host's clock and adds no wait for the
    card of its own.

    ``stats``: ``prefill_kernel_launches`` counts each kernel's launches in
    the prefill, by name, and ``prefill_launches_by_variant`` the
    flash-attention launches by variant (``flash_attention.
    launches_by_variant``); ``prefill_logits`` holds the prefill's logits
    and ``decode_logits`` the last step's (f32, on the CPU);
    ``decode_step_ms`` is the {"min", "mean", "max"} of the steps' times
    (CUDA events around each step on the card, the host clock on the
    CPU) and ``decode_captured`` whether decode ran as a graph;
    ``decode_attention_launches`` counts the decode-attention kernel's
    launches during the call: on the card an attention layer's two
    warm-up steps and its captured step (a replay runs the graph's
    kernels, not the wrapper), or each eager step's; 0 on the CPU, where
    the plain version runs.
    """
    cfg, device = model.cfg, model.device
    B, P = prompts.shape
    on_card = device.type == "cuda"
    decode_launches0 = decode_attention.launches
    with regions.annotate("serve/alloc_cache", category="api"):
        caches = model.alloc_cache(B, P + gen)
    prefill = make_prefill_step(cfg)
    if captured and on_card:
        with regions.annotate("serve/capture", category="api"):
            decode = CapturedDecode(model, caches, B)
    else:
        eager = make_decode_step(cfg)

        def decode(token, t):
            return eager(model, caches, {"tokens": token}, t)
    launches0 = _launches()
    variants0 = dict(flash_attention.launches_by_variant)
    with torch.no_grad():
        with regions.annotate_torch("serve/prefill", category="api") as box:
            logits = prefill(model, {"tokens": prompts}, caches)
            box["out"] = logits
            _sync(device)
        with regions.annotate("serve/prefill_readback", category="api"):
            finite = torch.isfinite(logits).all()
            prefill_logits = logits.float().cpu()
            prefill_launches = {name: n - launches0[name]
                                for name, n in _launches().items()}
            prefill_variants = {
                k: n - variants0[k]
                for k, n in flash_attention.launches_by_variant.items()}
            token = logits[:, 0].argmax(dim=-1).to(torch.int32)[:, None]
        out_tokens = [token]
        marks = []
        t0 = time.perf_counter()
        for t in range(P, P + gen):
            with regions.annotate_torch("serve/decode_step", category="api",
                                        pos=t) as box:
                marks.append(_mark(device))
                logits, next_tok = decode(token, t)
                # the graph's outputs are overwritten by the next replay
                token = next_tok[:, :1].clone()
                out_tokens.append(token)
                marks.append(_mark(device))
                box["out"] = token
                finite &= torch.isfinite(logits).all()
        with regions.annotate("serve/finish", category="api"):
            _sync(device)
            dt = time.perf_counter() - t0
            decode_logits = logits.float().cpu() if gen else None
            step_ms = [_elapsed_ms(a, b)
                       for a, b in zip(marks[::2], marks[1::2])]
            prefill_ev = [e for e in global_collector().drain()
                          if e.name == "serve/prefill"][-1]
            stats = {
                "device": str(device),
                "prefill_ms": prefill_ev.duration / 1e6,
                "decode_s": dt,
                "decode_tok_s": B * gen / dt if gen else float("nan"),
                "decode_step_ms": ({"min": min(step_ms),
                                    "mean": sum(step_ms) / gen,
                                    "max": max(step_ms)} if gen else None),
                "decode_captured": captured and on_card,
                "decode_attention_launches": (decode_attention.launches
                                              - decode_launches0),
                "prefill_kernel_launches": prefill_launches,
                "prefill_launches_by_variant": prefill_variants,
                "logits_finite": bool(finite),
                "prefill_logits": prefill_logits,
                "decode_logits": decode_logits,
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                      if on_card else None),
            }
            tokens = torch.cat(out_tokens, dim=1)
            # release the captured graph inside this region: destroying
            # it takes milliseconds
            del decode
    return tokens, stats


def _mark(device: torch.device):
    """A point in time on ``device``'s stream: a recorded CUDA event on
    the card, the host clock (ms) on the CPU."""
    if device.type != "cuda":
        return time.perf_counter() * 1e3
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b)


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
          f"({stats['decode_s'] / max(G, 1) * 1e3:.1f} ms/step, "
          f"{'captured' if stats['decode_captured'] else 'eager'})")
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
