"""Parameter spec tables + shared layer math (port of ``repro.models.common``).

Every module declares its parameters once as a dict of :class:`ParamSpec`;
:class:`SpecModule` turns such a table into an ``nn.Module`` whose
parameter paths mirror the JAX parameter tree (``mixer.wq``, ``ffn.wo``),
so weights carry across by name.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes                      # logical axis names, len == len(shape)
    init: str = "normal"            # normal | zeros | scaled
    scale: float = 0.02
    dtype: Any = None               # defaults to the compute dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


SpecTree = Dict[str, Any]           # nested dicts of ParamSpec


def param_dtype(spec: ParamSpec, compute: torch.dtype,
                trainable: bool = False) -> torch.dtype:
    """Trainable (master) weights are f32, as ``init_params`` makes them.
    Inference-only weights store matrices in the compute dtype and keep
    1-D scales (norms) in f32, as ``repro.models.model._cast`` leaves
    them."""
    if spec.dtype is not None:
        return spec.dtype
    if trainable or len(spec.shape) <= 1:
        return torch.float32
    return compute


class SpecModule(nn.Module):
    """An ``nn.Module`` built from a spec tree: one parameter per
    :class:`ParamSpec`, one child module per nested dict. ``m["wq"]``
    reads a parameter or child by its spec name."""

    def __init__(self, specs: SpecTree, compute: torch.dtype,
                 device: torch.device, trainable: bool = False):
        super().__init__()
        for name, spec in specs.items():
            if isinstance(spec, ParamSpec):
                self.register_parameter(name, nn.Parameter(torch.empty(
                    spec.shape, dtype=param_dtype(spec, compute, trainable),
                    device=device), requires_grad=trainable))
            else:
                self.add_module(name, SpecModule(spec, compute, device,
                                                 trainable))

    def __getitem__(self, name: str):
        return getattr(self, name)


# parameters that stay f32 in compute (routing / SSM dynamics / gate logits)
_KEEP_F32 = ("router", "A_log", "D", "w_if", "b_if", "dt_w", "dt_b")


def cast_params(module: nn.Module, dtype: torch.dtype) -> Dict[str, Any]:
    """The compute view of a module's parameters (``model._cast``): a nested
    dict by spec name in which f32 matrices are cast to ``dtype``; 1-D
    tensors, other dtypes and ``_KEEP_F32`` names are the parameters
    themselves. The cast is differentiable, so gradients reach the f32
    master weights in f32."""
    out: Dict[str, Any] = {}
    for name, p in module.named_parameters(recurse=False):
        keep = name in _KEEP_F32 or p.dim() <= 1 or p.dtype != torch.float32
        out[name] = p if keep else p.to(dtype)
    for name, child in module.named_children():
        out[name] = cast_params(child, dtype)
    return out


def init_param_(p: torch.Tensor, spec: ParamSpec, gen: torch.Generator) -> None:
    """Fill ``p`` in place from ``spec`` (same initializers as the JAX
    package, not the same random numbers)."""
    if spec.init == "zeros":
        p.zero_()
    elif spec.init in ("normal", "scaled"):
        std = spec.scale
        if spec.init == "scaled":
            std = spec.scale / math.sqrt(max(1, spec.shape[0] if spec.shape else 1))
        x = torch.randn(spec.shape, generator=gen, device=p.device,
                        dtype=torch.float32)
        p.copy_(x.mul_(std))
    else:
        raise NotImplementedError(f"initializer {spec.init!r}")


def init_module_(module: nn.Module, specs_by_prefix: Dict[str, ParamSpec],
                 seed: int) -> None:
    """Seeded init of every parameter named in ``specs_by_prefix``.

    Each tensor draws from its own generator, seeded from ``seed`` and a
    stable hash of its path (``zlib.crc32``; Python's ``hash`` is salted
    per process), so a tensor's values do not depend on init order.
    """
    params = dict(module.named_parameters())
    for path, spec in specs_by_prefix.items():
        p = params[path]
        gen = torch.Generator(device=p.device)
        gen.manual_seed(zlib.crc32(f"{seed}:{path}".encode()))
        with torch.no_grad():
            init_param_(p, spec, gen)


# ---------------------------------------------------------------------------
# shared layer math
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in f32, scaled by ``(1 + scale)``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    # jax.nn.gelu defaults to the tanh approximation
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    }[name]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # a Python-float base: no host-to-device copy (which would synchronize)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Half-split (not interleaved) RoPE in f32.
    x: (..., T, H, D); positions: (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    angles = positions[..., :, None].float() * freqs             # (..., T, D/2)
    cos = torch.cos(angles)[..., :, None, :]                     # (..., T, 1, D/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
