"""Mamba-1 selective-state-space mixer, jamba's sequence layer (port of
``repro.models.mamba``).

Prefill and train run the whole sequence through
:func:`repro_torch.kernels.mamba_scan.ops.selective_scan` (the CUDA kernel
on the card, its plain version on the CPU). Prefill takes the cache's
state from the scan's final state. The JAX package runs a jnp scan in
chunks of 128 steps over time padded to a multiple of the chunk, and keeps
the state after the pad steps; the port pads nothing and keeps the state
after the last prompt token. Train writes no cache, so the pad steps do
not reach it: its gradient through the scan is the CUDA backward kernel
on the card (``SelectiveScan``), autograd through the plain version on the
CPU, where the JAX package differentiates its jnp scan with ``jax.grad``.
Decode is one recurrence step against the carried (h, conv tail) cache,
in plain torch, as the JAX package does it in jnp.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.mamba_scan.ops import selective_scan
from .common import ParamSpec


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    return d_inner, m.d_state, m.d_conv, m.dt_rank_for(cfg.d_model)


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    E = cfg.d_model
    dI, N, dC, R = _dims(cfg)
    return {
        "in_proj": ParamSpec((E, 2 * dI), ("embed", "inner")),
        "conv_w": ParamSpec((dC, dI), (None, "inner"), init="normal", scale=0.1),
        "conv_b": ParamSpec((dI,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((dI, R + 2 * N), ("inner", None)),
        "dt_w": ParamSpec((R, dI), (None, "inner")),
        "dt_b": ParamSpec((dI,), ("inner",), init="const", scale=-4.6),  # softplus^-1(0.01)
        "A_log": ParamSpec((dI, N), ("inner", "state"), init="mamba_a",
                           dtype=torch.float32),
        "D": ParamSpec((dI,), ("inner",), init="ones", dtype=torch.float32),
        "out_proj": ParamSpec((dI, E), ("inner", "embed"), init="scaled", scale=1.0),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time in x's dtype. x: (B, T, dI); w:
    (dC, dI); ``tail`` the (B, dC-1, dI) inputs before x (zeros if None).
    The taps are summed in order, then the bias, as the JAX package's
    ``sum``; the bias (an f32 1-D parameter here) is cast to x's dtype."""
    dC, T = w.shape[0], x.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, dC - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, dC):
        out = out + xp[:, i:i + T] * w[i]
    return out + b.to(x.dtype)


def _project(params, xc: torch.Tensor, R: int, N: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dt, Bc, Cc), all f32; Bc and Cc are views into one (…, R+2N)
    projection."""
    x_dbl = (xc @ params["x_proj"]).float()
    dt_low, Bc, Cc = x_dbl.split([R, N, N], dim=-1)
    dt = F.softplus(dt_low @ params["dt_w"].float() + params["dt_b"].float())
    return dt, Bc, Cc


def mamba_apply(
    params,
    x: torch.Tensor,                         # (B, T, E)
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]],
    mode: str = "prefill",                   # train | prefill | decode
) -> torch.Tensor:
    """Returns the mixer output (B, T, E). Prefill writes the final state
    and the conv tail into ``cache``; decode (T = 1) steps them, in
    place; train is prefill's computation without a cache."""
    B, T, E = x.shape
    dI, N, dC, R = _dims(cfg)
    A = -torch.exp(params["A_log"].float())                      # (dI, N)
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError("decode takes one token and a cache")
        conv_tail = cache["conv"]                                # (B, dC-1, dI)
        xc = F.silu(_causal_conv(xin, params["conv_w"], params["conv_b"],
                                 tail=conv_tail))
        dt, Bc, Cc = _project(params, xc, R, N)                  # (B, 1, *)
        dA = torch.exp(dt[:, 0, :, None] * A)                    # (B, dI, N)
        dBx = (dt[:, 0] * xc[:, 0])[..., None] * Bc[:, 0, None, :]
        h = dA * cache["h"] + dBx
        y = (h * Cc[:, 0, None, :]).sum(-1) + params["D"] * xc[:, 0]
        y = (y[:, None] * F.silu(z)).to(x.dtype)
        cache["conv"].copy_(torch.cat([conv_tail[:, 1:], xin], dim=1))
        cache["h"].copy_(h)
        return y @ params["out_proj"]
    if mode not in ("train", "prefill"):
        raise ValueError(
            f"mamba runs train, prefill or decode, got mode={mode!r}")

    xc = F.silu(_causal_conv(xin, params["conv_w"], params["conv_b"]))
    dt, Bc, Cc = _project(params, xc, R, N)
    y, h = selective_scan(xc, dt, A, Bc, Cc, params["D"], return_state=True)
    out = (y * F.silu(z)).to(x.dtype) @ params["out_proj"]
    if mode == "prefill" and cache is not None:
        cache["h"].copy_(h)
        # the last dC-1 raw conv inputs (zero-padded if T < dC-1)
        cache["conv"].copy_(F.pad(xin, (0, 0, dC - 1, 0))[:, -(dC - 1):])
    return out


def alloc_cache(cfg: ModelConfig, batch: int, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """Zero decode cache of one mamba mixer (``mamba_cache_specs``): the
    state (B, dI, N) f32 and the conv tail (B, dC-1, dI) in cfg.dtype."""
    dI, N, dC, _ = _dims(cfg)
    return {
        "h": torch.zeros((batch, dI, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, dC - 1, dI), dtype=getattr(torch, cfg.dtype),
                            device=device),
    }
