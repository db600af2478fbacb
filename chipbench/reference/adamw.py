"""AdamW with decoupled weight decay, global-norm clipping and a
constant learning rate after a linear warm-up, in plain f32 PyTorch: the
update the training cells' configuration states (the ``optimizer`` keys
of the traffic mix). Weight decay skips 1-D tensors (the norms)."""
from __future__ import annotations

from typing import Dict

import torch


def lr_at(opt: dict, step: int) -> float:
    return opt["lr"] * min(1.0, step / max(1, opt["warmup_steps"]))


@torch.no_grad()
def step(params: Dict[str, torch.Tensor], state: Dict, opt: dict) -> None:
    """One update of ``params`` from their ``.grad``, in place; ``state``
    holds ``m``, ``v`` and ``step``."""
    t = state["step"] + 1
    lr = lr_at(opt, t)
    norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in params.values()))
    scale = torch.clamp(opt["clip_norm"] / torch.clamp_min(norm, 1e-12), max=1.0)
    b1, b2 = opt["b1"], opt["b2"]
    for name, p in params.items():
        g = p.grad * scale
        m = state["m"].setdefault(name, torch.zeros_like(p))
        v = state["v"].setdefault(name, torch.zeros_like(p))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + opt["eps"])
        if p.dim() > 1:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
    state["step"] = t
