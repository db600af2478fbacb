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

from ..sharding.rules import replicated_like

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes                      # logical axis names, len == len(shape)
    init: str = "normal"            # normal | zeros | ones | scaled | mamba_a | const
    scale: float = 0.02
    dtype: Any = None               # defaults to the compute dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


SpecTree = Dict[str, Any]           # nested dicts of ParamSpec

# parameters that stay f32 in compute (routing / SSM dynamics / gate logits)
_KEEP_F32 = ("router", "A_log", "D", "w_if", "b_if", "dt_w", "dt_b")


def param_dtype(spec: ParamSpec, compute: torch.dtype,
                trainable: bool = False, name: str = "") -> torch.dtype:
    """Trainable (master) weights are f32, as ``init_params`` makes them.
    Inference-only weights store matrices in the compute dtype and keep
    1-D scales (norms) and the ``_KEEP_F32`` parameters (routing, SSM
    dynamics) in f32, as ``repro.models.model._cast`` leaves them."""
    if spec.dtype is not None:
        return spec.dtype
    if trainable or len(spec.shape) <= 1 or name in _KEEP_F32:
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
                    spec.shape, dtype=param_dtype(spec, compute, trainable,
                                                  name),
                    device=device), requires_grad=trainable))
            else:
                self.add_module(name, SpecModule(spec, compute, device,
                                                 trainable))

    def __getitem__(self, name: str):
        return getattr(self, name)


def cast_params(module: nn.Module, dtype: torch.dtype,
                pre: Optional[Callable[[str, torch.Tensor], torch.Tensor]]
                = None, prefix: str = "") -> Dict[str, Any]:
    """The compute view of a module's parameters (``model._cast``): a nested
    dict by spec name in which f32 matrices are cast to ``dtype``; 1-D
    tensors, other dtypes and ``_KEEP_F32`` names are the parameters
    themselves. The cast is differentiable, so gradients reach the f32
    master weights in f32. ``pre(path, p)``, when given, maps each
    parameter (by its dotted path under ``module``) before the cast."""
    out: Dict[str, Any] = {}
    for name, p in module.named_parameters(recurse=False):
        if pre is not None:
            p = pre(prefix + name, p)
        keep = name in _KEEP_F32 or p.dim() <= 1 or p.dtype != torch.float32
        out[name] = p if keep else p.to(dtype)
    for name, child in module.named_children():
        out[name] = cast_params(child, dtype, pre, f"{prefix}{name}.")
    return out


# splitmix64's finalizer constants, as signed 64-bit integers
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
_NORMAL_CHUNK = 1 << 21


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` by ``s`` bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors (wrapping products)."""
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def normal_(p: torch.Tensor, seed: int) -> None:
    """Fill contiguous ``p`` in place with standard normals that depend on
    ``seed`` and each element's index only, not on the device: a hash of
    (seed, index) in integer arithmetic gives two 24-bit uniforms, and
    Box-Muller one normal. The same model made on the card and on the CPU
    so holds the same weights, up to an ulp of f32 ``log`` and ``cos``
    (``torch.Generator`` draws other numbers on each device). Drawn in
    chunks, so the integer temporaries stay small at any width."""
    flat = p.view(-1)
    key = int(_mix(torch.tensor([seed], dtype=torch.int64))[0])
    for lo in range(0, flat.numel(), _NORMAL_CHUNK):
        n = min(_NORMAL_CHUNK, flat.numel() - lo)
        i = torch.arange(2 * lo, 2 * (lo + n), dtype=torch.int64,
                         device=p.device) + key
        u = ((_srl(_mix(i), 40) + 0.5) * 2.0 ** -24).to(torch.float32)
        u1, u2 = u[0::2], u[1::2]
        flat[lo:lo + n] = (torch.sqrt(-2.0 * torch.log(u1))
                           * torch.cos(2.0 * math.pi * u2))


def init_param_(p: torch.Tensor, spec: ParamSpec, seed: int) -> None:
    """Fill ``p`` in place from ``spec`` (same initializers as the JAX
    package, not the same random numbers; normals from :func:`normal_`).
    ``scaled`` divides by the fan-in, ``shape[-2]`` (``shape[0]`` of a 1-D
    spec): the input width of a matrix, and of each expert's matrix in an
    (experts, in, out) stack."""
    if spec.init == "zeros":
        p.zero_()
    elif spec.init == "ones":
        p.fill_(1.0)
    elif spec.init == "const":
        p.fill_(spec.scale)
    elif spec.init == "mamba_a":
        # S4D-real: A = -(1..d_state) over d_inner, stored as log(-A)
        a = torch.arange(1, spec.shape[-1] + 1, dtype=torch.float32,
                         device=p.device)
        p.copy_(torch.log(a).expand(spec.shape))
    elif spec.init in ("normal", "scaled"):
        std = spec.scale
        if spec.init == "scaled":
            fan_in = spec.shape[-2] if len(spec.shape) > 1 else (
                spec.shape[0] if spec.shape else 1)
            std = spec.scale / math.sqrt(max(1, fan_in))
        x = torch.empty(spec.shape, dtype=torch.float32, device=p.device)
        normal_(x, seed)
        p.copy_(x.mul_(std))
    else:
        raise NotImplementedError(f"initializer {spec.init!r}")


def init_module_(module: nn.Module, specs_by_prefix: Dict[str, ParamSpec],
                 seed: int) -> None:
    """Seeded init of every parameter named in ``specs_by_prefix``.

    Each tensor draws from its own seed, made from ``seed`` and a stable
    hash of its path (``zlib.crc32``; Python's ``hash`` is salted per
    process), so a tensor's values depend neither on init order nor on
    the device.
    """
    params = dict(module.named_parameters())
    for path, spec in specs_by_prefix.items():
        with torch.no_grad():
            init_param_(params[path], spec,
                        zlib.crc32(f"{seed}:{path}".encode()))


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
    cos = replicated_like(torch.cos(angles)[..., :, None, :], x)  # (..., T, 1, D/2)
    sin = replicated_like(torch.sin(angles)[..., :, None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
