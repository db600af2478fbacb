"""The training cells: the port's train step (``make_train_step`` on a
trainable ``Model`` with the port's AdamW state) driven step after step.

Set-up builds the model, fills its f32 master weights from the seed and
drives that one model and optimizer state through the mix's first
``check_steps`` steps by the window's own call and feed, on bigram rows
that all differ; these steps also warm every kernel up. It reads each
step's loss, after the first step the norm of each leaf's gradient as
AdamW got it (its first moment over 1 - b1), and after the last the norm
of each leaf's change from its initial value. The window then trains on
from there, a batch a step, each step's loss read back (which waits for
the card), until the window's seconds have passed; the rate is every
token trained over the window's time.

Once the window has closed and the program is freed, the reference takes
the same initial weights and the same batches through the same steps in
f32 and is held to those readings (:mod:`chipbench.check`).
"""
from __future__ import annotations

import gc
import importlib
import time
from typing import Any, Dict, List

import torch

from . import cells, check, traffic, weights
from .reference.common import exact_matmuls


def run(c: Dict, args, ctx) -> Dict[str, Any]:
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    d = cells.dims(c["config_file"], ctx.smoke)
    mix = cells.sized(c["traffic_file"], ctx.smoke)
    cfg = cells.port_config(d, ctx.smoke)
    device, seed = ctx.device, args.seed
    opt = mix["optimizer"]
    B, T = mix["batch"], mix["seq_len"]
    rows = B // 2 if getattr(args, "fault", None) == "half_batch" else B

    model = Model(cfg, device, trainable=True)
    weights.fill(model, d, seed)
    params = dict(model.named_parameters())
    state = adamw.init_state(params)
    step_fn = make_train_step(cfg, adamw.AdamWConfig(
        lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
        weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"],
        schedule="constant", warmup_steps=opt["warmup_steps"]))
    data = traffic.SyntheticTokens(d["vocab_size"], seed, B, T,
                                   mix["n_successors"])

    def step(i: int) -> float:
        b = data.batch_at(i)
        batch = {k: torch.from_numpy(v[:rows]).to(device=device,
                                                  dtype=torch.long)
                 for k, v in b.items()}
        return float(step_fn(model, state, batch)["loss"])

    n_check = mix["check_steps"]
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for i in range(n_check):
        losses.append(step(i))
        if i == 0:
            grad1 = {n: float(state["m"][n].norm()) / (1 - opt["b1"])
                     for n in params}
    table = weights.specs(d)
    with torch.no_grad():
        change = {n: float((p - weights.make(n, table[n], seed, device,
                                             torch.float32)).norm())
                  for n, p in params.items()}
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    steps: List[Dict[str, Any]] = []

    def window() -> float:
        t0 = time.perf_counter()
        i = n_check
        while True:
            start = time.perf_counter_ns()
            with ctx.span("chipbench/step"):
                step(i)
            steps.append({"t0_ns": start, "t1_ns": time.perf_counter_ns()})
            i += 1
            done = (len(steps) >= mix["trace_steps"] if args.trace
                    else time.perf_counter() - t0 >= args.seconds)
            if done:
                return t0

    trace = None
    if args.trace:
        t0, trace = ctx.profile(window)
    else:
        t0 = window()
    elapsed = steps[-1]["t1_ns"] / 1e9 - t0
    peak = ctx.memory_peak()
    del model, params, state, step_fn
    gc.collect()
    ctx.empty_cache()

    ref = importlib.import_module(f"chipbench.reference.{d['reference']}")
    exact_matmuls()
    sound = _reference(ref, d, data, mix, seed, device, n_check)
    readings = _checks(losses, grad1, change, sound)
    control = None
    if args.control:
        ctl = _reference(ref, d, data, mix, seed, device, n_check, "fp8")
        control = _checks(ctl["losses"], ctl["grad1"], ctl["change"], sound)
    return {
        "setup_s": setup_s,
        "end_to_end": {"train_tokens_per_s": len(steps) * B * T / elapsed},
        "attempted": len(steps), "failed": 0,
        "memory_peak_bytes": peak, "readings": readings, "control": control,
        "record": {"kind": "train", "dims": d, "mix": mix, "steps": steps},
        "trace": trace,
    }


def _reference(ref, d: Dict, data, mix: Dict, seed: int,
               device: torch.device, n_steps: int, quant=None) -> Dict:
    """The reference's losses, first clipped gradient norms and changes
    after ``n_steps`` steps, by leaf, from the same weights and batches."""
    from .reference import adamw as ref_adamw

    table = weights.specs(d)
    params = {n: weights.make(n, s, seed, device, torch.float32)
              .requires_grad_(True) for n, s in table.items()}
    state = {"m": {}, "v": {}, "step": 0}
    opt = mix["optimizer"]
    losses, grad1 = [], {}
    for i in range(n_steps):
        b = data.batch_at(i)
        tokens, labels = (torch.from_numpy(b[k]).to(device=device,
                                                    dtype=torch.long)
                          for k in ("tokens", "labels"))
        loss = ref.train_loss(d, params, tokens, labels, quant)
        loss.backward()
        losses.append(float(loss.detach()))
        if i == 0:
            norm = torch.sqrt(sum(torch.sum(p.grad * p.grad)
                                  for p in params.values()))
            scale = min(1.0, opt["clip_norm"] / max(float(norm), 1e-12))
            grad1 = {n: float(p.grad.norm()) * scale
                     for n, p in params.items()}
        ref_adamw.step(params, state, opt)
        for p in params.values():
            p.grad = None
    with torch.no_grad():
        change = {n: float((p - weights.make(n, table[n], seed, device,
                                             torch.float32)).norm())
                  for n, p in params.items()}
    out = {"losses": losses, "grad1": grad1, "change": change}
    del params, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _checks(losses: List[float], grad1: Dict[str, float],
            change: Dict[str, float], ref: Dict) -> Dict[str, float]:
    """The three numbers compared: the widest relative gap of a step's
    loss, and the worst leaf's gap of the first gradient's norm and of
    the change's norm (:func:`chipbench.check.leaf_gap`); leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    import numpy as np

    median = float(np.median(list(ref["grad1"].values())))
    still = [n for n, g in ref["grad1"].items() if g < 1e-3 * median]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(losses, ref["losses"])),
        "grad_gap": check.leaf_gap(grad1, ref["grad1"]),
        "change_gap": check.leaf_gap(change, ref["change"], skip=still),
    }
