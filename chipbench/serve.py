"""The serving cells: the port's ``generate`` driven batch after batch by
an open loop of arriving requests.

Set-up builds the port's ``Model``, fills its weights from the seed,
makes every request's prompt and runs ``generate`` once at each prompt
length of the mix. The window then serves the requests as they arrive:
whenever the server is free it takes the oldest waiting request and up
to ``batch`` waiting requests of its prompt length, in arrival order, and
runs them as one ``generate`` call (cache, captured decode, prefill,
``gen`` decode steps), which hands back every token when it returns.

With ``"drain": true`` (a cell below the server's capacity) every request
that arrives in the window is served, and a request's latency runs from
its arrival to the return of its call. With ``"drain": false`` (above
capacity) batches start until the window closes, and the rate is every
token they generated over the time from the window's start to the last
return.

Once the window has closed and the program is freed, the reference runs
over a sample of the finished batches drawn from the seed, one batch of
each prompt length, the longest first, and the number compared is the
widest gap by which a served token's reference logit lies below the
reference's best at its position.
"""
from __future__ import annotations

import gc
import importlib
import random
import time
from typing import Any, Dict, List

import torch

from . import cells, check, traffic, weights
from .reference.common import exact_matmuls


def _batch_sizes(mix: Dict) -> List[int]:
    """The batch sizes the server can form from the mix's bursts."""
    return sorted({min(mix["batch"], k * mix["burst"])
                   for k in range(1, -(-mix["batch"] // mix["burst"]) + 1)})


def run(c: Dict, args, ctx) -> Dict[str, Any]:
    from repro_torch.core.collector import global_collector
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model

    d = cells.dims(c["config_file"], ctx.smoke)
    mix = cells.sized(c["traffic_file"], ctx.smoke)
    cfg = cells.port_config(d, ctx.smoke)
    device, seed = ctx.device, args.seed
    B, gen = mix["batch"], mix["gen"]
    collector = global_collector()

    model = Model(cfg, device)
    weights.fill(model, d, seed)
    reqs = traffic.schedule(mix, args.seconds)
    if args.trace:
        reqs = reqs[:mix["trace_batches"] * mix["burst"]]
    prompt = {r.index: traffic.prompts(seed, r.index, 1, r.prompt_len,
                                       d["vocab_size"], device)[0]
              for r in reqs}
    for L in sorted({r.prompt_len for r in reqs}):
        for n in _batch_sizes(mix):
            warm = traffic.prompts(seed, -1, n, L, d["vocab_size"], device)
            generate(model, warm, mix.get("warmup_gen", gen))
    ctx.sync()
    collector.clear()
    setup_s = time.perf_counter() - ctx.t_start

    calls: List[Dict[str, Any]] = []
    latency_ms: List[float] = []

    def window() -> float:
        t0 = time.perf_counter()
        waiting: List[Any] = []
        i = 0
        while True:
            now = time.perf_counter() - t0
            while i < len(reqs) and reqs[i].arrival_s <= now:
                waiting.append(reqs[i])
                i += 1
            if not mix["drain"] and now >= args.seconds:
                break
            if not waiting:
                if i >= len(reqs):
                    break
                time.sleep(max(0.0, reqs[i].arrival_s - now))
                continue
            L = waiting[0].prompt_len
            batch = [r for r in waiting if r.prompt_len == L][:B]
            waiting = [r for r in waiting if r not in batch]
            start = time.perf_counter_ns()
            with ctx.span("chipbench/call"):
                prompts = torch.stack([prompt[r.index] for r in batch])
                out, stats = generate(model, prompts, gen)
                out = out.cpu()
            end = time.perf_counter_ns()
            pre = [e for e in collector.drain() if e.name == "serve/prefill"]
            collector.clear()
            calls.append({
                "n": len(batch), "P": L, "gen": gen, "t0_ns": start,
                "t1_ns": end, "requests": [r.index for r in batch],
                "prefill_start_ns": pre[-1].t_start if pre else None,
                "prefill_ms": stats["prefill_ms"],
                "decode_ms_mean": (stats["decode_step_ms"] or {}).get("mean"),
                "tokens": out})
            latency_ms.extend((end / 1e9 - t0 - r.arrival_s) * 1e3
                              for r in batch)
        return t0

    trace = None
    if args.trace:
        t0, trace = ctx.profile(window)
    else:
        t0 = window()
    elapsed_s = max(cl["t1_ns"] for cl in calls) / 1e9 - t0
    tokens = sum(cl["n"] * (cl["gen"] + 1) for cl in calls)
    peak = ctx.memory_peak()

    del model
    gc.collect()
    ctx.empty_cache()

    sample = _sample(calls, seed, mix["check_batches"])
    ref = importlib.import_module(f"chipbench.reference.{d['reference']}")
    exact_matmuls()
    w = weights.Weights(d, seed, device, getattr(torch, d["dtype"]))
    gaps, control = [], []
    with torch.no_grad():
        for cl in sample:
            toks = torch.stack([prompt[i] for i in cl["requests"]])
            served = cl["tokens"].to(device=device, dtype=torch.long)
            seq = torch.cat([toks, served[:, :-1]], dim=1)
            lg = ref.serve_logits(d, w, seq, cl["P"] - 1, cl["P"])
            gaps.append(check.served_gaps(lg, served, d["vocab_size"]))
            if args.control:
                ctl = ref.serve_logits(d, w, seq, cl["P"] - 1, cl["P"],
                                       quant="fp8")
                control.append(check.served_gaps(lg, ctl.argmax(dim=-1),
                                                 d["vocab_size"]))
    record = {"kind": "serve", "dims": d, "mix": mix, "calls": [
        {k: v for k, v in cl.items() if k != "tokens"} for cl in calls]}
    return {
        "setup_s": setup_s,
        "end_to_end": {
            "serve_latency_p95_ms": check.percentile(latency_ms, 95),
            "serve_output_tokens_per_s": tokens / elapsed_s,
        },
        "attempted": len(latency_ms), "failed": 0,
        "memory_peak_bytes": peak,
        "readings": check.gap_readings(torch.cat(gaps)),
        "control": (check.gap_readings(torch.cat(control)) if control
                    else None),
        "record": record, "trace": trace,
    }


def _sample(calls: List[Dict], seed: int, n: int) -> List[Dict]:
    """``n`` finished calls drawn from the seed: one of each prompt
    length, the longest first."""
    rng = random.Random(seed)
    by_len: Dict[int, List[Dict]] = {}
    for cl in calls:
        by_len.setdefault(cl["P"], []).append(cl)
    return [rng.choice(by_len[L]) for L in sorted(by_len, reverse=True)][:n]
