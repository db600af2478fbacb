"""AdamW with decoupled weight decay, global-norm clipping and schedules
(port of ``repro.optim.adamw``).

Parameters, gradients and the optimizer state (m, v) are f32 dicts keyed
by parameter name (``layers.0.mixer.wq``). Where the JAX package returns
new trees, :func:`apply_updates` updates the parameters and the state in
place: on one card, a second copy of 16 B a parameter would not fit.
The formulas, their order and the f32 arithmetic are those of the JAX
package; the step count and the learning rate are host scalars.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from ..sharding.rules import unshard


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"           # constant | cosine | wsd (minicpm)
    warmup_steps: int = 100
    total_steps: int = 10000
    decay_frac: float = 0.1            # wsd: final fraction of steps decaying
    min_lr_ratio: float = 0.1


def schedule_fn(cfg: AdamWConfig) -> Callable[[int], float]:
    """Learning rate at a step, in f32 as the JAX package computes it."""
    f32 = np.float32

    def fn(step: int) -> float:
        step = f32(step)
        warm = np.minimum(f32(1.0), step / f32(max(1, cfg.warmup_steps)))
        if cfg.schedule == "constant":
            return float(f32(cfg.lr) * warm)
        if cfg.schedule == "wsd":
            # Warmup-Stable-Decay (MiniCPM): constant plateau then a short
            # (decay_frac) 1-sqrt decay to min_lr_ratio.
            decay_steps = f32(cfg.total_steps * cfg.decay_frac)
            start = f32(cfg.total_steps) - decay_steps
            frac = np.clip((step - start) / np.maximum(decay_steps, f32(1)),
                           f32(0), f32(1))
            decay = f32(1.0) - f32(1.0 - cfg.min_lr_ratio) * np.sqrt(frac)
            return float(f32(cfg.lr) * warm * decay)
        # cosine
        t = np.clip((step - f32(cfg.warmup_steps))
                    / f32(max(1, cfg.total_steps - cfg.warmup_steps)),
                    f32(0), f32(1))
        cos = f32(cfg.min_lr_ratio) + f32(1 - cfg.min_lr_ratio) * f32(0.5) * (
            f32(1) + np.cos(f32(np.pi) * t))
        return float(f32(cfg.lr) * warm * cos)

    return fn


def init_state(params: Dict[str, torch.Tensor]) -> Dict:
    """Zero f32 (m, v) beside each parameter, placed as the parameter is
    (a DTensor parameter gets DTensor moments), and step 0."""
    zeros = {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
             for n, p in params.items()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": 0}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32, on the device.
    A DTensor's sum of squares is its global one (a collective), so every
    rank gets the same norm and clips by the same factor."""
    sums = [unshard(torch.sum(torch.square(x.float()))) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def decay_mask(name: str) -> bool:
    """True if weight decay applies (matrices; not norms/biases/scalars),
    judged by the last component of the parameter's name."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("A_log", "D", "dt_b", "b_if", "b_gates", "gate", "skip"):
        return False
    return "norm" not in leaf


@torch.no_grad()
def apply_updates(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: Dict,
    cfg: AdamWConfig,
) -> Dict[str, object]:
    """One AdamW step, in place on ``params`` and ``state``.

    Returns the metrics ``grad_norm`` (a device tensor, the norm before
    clipping) and ``lr`` (a float). DTensor parameters update on their
    local shards: each gradient is first placed as its parameter.
    """
    step = state["step"] + 1
    lr = schedule_fn(cfg)(step)
    gnorm = global_norm(grads.values())
    if cfg.clip_norm is not None:
        scale = torch.where(gnorm > cfg.clip_norm,
                            cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            torch.ones_like(gnorm))
    else:
        scale = torch.ones_like(gnorm)
    b1c = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(step))
    for name, p in params.items():
        g, s = grads[name], scale
        if isinstance(p, DTensor):
            if g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)
            s = DTensor.from_local(scale, p.device_mesh,
                                   [Replicate()] * p.device_mesh.ndim)
        g = g.float() * s
        m, v = state["m"][name], state["v"][name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decay_mask(name):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
