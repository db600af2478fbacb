"""One pattern position = pre-norm mixer + FFN (port of ``repro.models.blocks``).

Mixers ``attn`` and ``mamba``, FFNs ``mlp`` and ``moe`` are ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import LayerSpec, ModelConfig
from . import attention, mamba, moe
from .common import ParamSpec, activation, rms_norm

# where in ROADMAP.md the parts not ported yet are queued
_NOT_PORTED = {
    "mlstm": "ROADMAP Queue 1, modules still missing (xlstm.py)",
    "slstm": "ROADMAP Queue 1, modules still missing (xlstm.py)",
    "cross_attn": "ROADMAP Queue 1, modules still missing (vlm cross-attention)",
    "window": "ROADMAP Queue 1, modules still missing (sliding-window "
              "ring-buffer KV cache)",
}
_MIXERS = ("attn", "mamba")
_FFNS = ("mlp", "moe")


def _check_ported(spec: LayerSpec) -> None:
    for part, what in ((spec.mixer, "mixer"), (spec.ffn, "ffn")):
        if part in _NOT_PORTED:
            raise NotImplementedError(
                f"{what}={part!r} is not ported yet: {_NOT_PORTED[part]}")
    if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
        raise NotImplementedError(
            f"layer {spec} is not ported yet: ROADMAP Queue 1")
    if spec.cross_attn:
        raise NotImplementedError(
            f"cross_attn is not ported yet: {_NOT_PORTED['cross_attn']}")
    if spec.window is not None:
        raise NotImplementedError(
            f"window={spec.window} is not ported yet: {_NOT_PORTED['window']}")


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    E, F = cfg.d_model, cfg.d_ff
    return {
        "wg": ParamSpec((E, F), ("embed", "mlp")),
        "wi": ParamSpec((E, F), ("embed", "mlp")),
        "wo": ParamSpec((F, E), ("mlp", "embed"), init="scaled", scale=1.0),
    }


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    h = act(x @ params["wg"]) * (x @ params["wi"])
    return h @ params["wo"]


def block_specs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Any]:
    _check_ported(spec)
    return {
        "norm_mixer": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "mixer": (attention.attn_specs(cfg) if spec.mixer == "attn"
                  else mamba.mamba_specs(cfg)),
        "norm_ffn": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "ffn": mlp_specs(cfg) if spec.ffn == "mlp" else moe.moe_specs(cfg),
    }


def alloc_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq_len: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty decode cache of one layer's mixer: a KV cache of ``seq_len``
    slots for attention, the state and conv tail for mamba."""
    if spec.mixer == "attn":
        return attention.alloc_cache(cfg, batch, seq_len, device)
    return mamba.alloc_cache(cfg, batch, device)


def block_apply(params, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                pos: int, cache: Optional[Dict[str, torch.Tensor]],
                mode: str = "prefill"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-norm mixer + pre-norm FFN, each with a residual. ``mode``
    (train | prefill | decode) and ``cache`` go to the mixer. Returns (x,
    aux), aux the MoE stats (empty for an MLP)."""
    h = rms_norm(x, params["norm_mixer"], cfg.norm_eps)
    if spec.mixer == "attn":
        x = x + attention.attn_apply(params["mixer"], h, cfg, pos, cache,
                                     mode=mode)
    else:
        x = x + mamba.mamba_apply(params["mixer"], h, cfg, cache, mode=mode)
    h = rms_norm(x, params["norm_ffn"], cfg.norm_eps)
    if spec.ffn == "mlp":
        return x + mlp_apply(params["ffn"], h, cfg), {}
    out, aux = moe.moe_apply(params["ffn"], h, cfg)
    return x + out, aux
