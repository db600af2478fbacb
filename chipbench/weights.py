"""Weights made from the seed, tensor by tensor, on the device.

Every parameter has a name (its path: ``embed``, ``layers.3.mixer.wq``,
...), a shape and an initializer, all given by :func:`specs` from the
configuration's sizes, as the family's reference module tables them. Its
values come from a ``torch.Generator`` on the device seeded from (seed,
name): normals drawn in f32 in one call, scaled, then stored in the type
the program holds the tensor in. So the program's model is filled in
place (:func:`fill`), and the references draw the very same tensor
again, layer by layer, once the program is gone (:func:`make`).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from . import cells
from .reference.common import Spec

# parameters the inference model keeps in f32 (the rest in its dtype)
KEEP_F32 = ("router", "A_log", "D", "dt_w", "dt_b")


def specs(d: dict) -> Dict[str, Spec]:
    """Every parameter of the model of sizes ``d``, by name, as the
    family's reference module (``d["reference"]``) tables them."""
    return cells.family(d).specs(d)


def stored_dtype(name: str, shape, compute: torch.dtype, trainable: bool
                 ) -> torch.dtype:
    """The type the program holds a parameter in: f32 when it trains
    (master weights), and for 1-D tensors and ``KEEP_F32``; else the
    compute type."""
    if trainable or len(shape) <= 1 or name.rsplit(".", 1)[-1] in KEEP_F32:
        return torch.float32
    return compute


def _key(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def make(name: str, spec: Spec, seed: int, device: torch.device,
         dtype: torch.dtype) -> torch.Tensor:
    """The tensor ``name`` of ``spec``, drawn from ``seed``, in ``dtype``."""
    shape, init, scale = spec
    if init == "log_range":
        row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                     device=device))
        return row.expand(shape).to(dtype).clone()
    g = torch.Generator(device=device)
    g.manual_seed(_key(seed, name))
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(generator=g)
    if init == "normal":
        x.mul_(scale)
    elif init == "fan_in":
        x.mul_(scale / math.sqrt(shape[-2]))
    elif init == "around":
        x.mul_(0.1).add_(scale)
    else:
        raise ValueError(f"initializer {init!r}")
    return x.to(dtype)


def fill(model: torch.nn.Module, d: dict, seed: int) -> None:
    """Fill every parameter of the port's ``model`` in place from
    ``seed``. The model's parameters must be exactly those of
    :func:`specs`, of the same shapes."""
    table = specs(d)
    params = dict(model.named_parameters())
    if set(params) != set(table):
        raise SystemExit(f"the port's parameters differ from the benchmark's: "
                         f"{sorted(set(params) ^ set(table))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            want = stored_dtype(name, table[name][0], model.compute_dtype,
                                model.trainable)
            if tuple(p.shape) != table[name][0] or p.dtype != want:
                raise SystemExit(f"{name}: the port holds {tuple(p.shape)} "
                                 f"{p.dtype}, the benchmark {table[name][0]} "
                                 f"{want}")
            p.copy_(make(name, table[name], seed, p.device, p.dtype))


class Weights:
    """The references' view of the weights: ``w(name)`` draws the tensor
    again in the type the program held it in (``compute`` and
    ``trainable`` as the program's model had them) and returns it in
    f32."""

    def __init__(self, d: dict, seed: int, device: torch.device,
                 compute: torch.dtype, trainable: bool = False):
        self.table = specs(d)
        self.seed, self.device = seed, device
        self.compute, self.trainable = compute, trainable

    def __call__(self, name: str) -> torch.Tensor:
        spec = self.table[name]
        dt = stored_dtype(name, spec[0], self.compute, self.trainable)
        return make(name, spec, self.seed, self.device, dt).float()
