"""One pattern position = pre-norm mixer + FFN (port of ``repro.models.blocks``).

This slice ports the dense path: ``mixer="attn"`` with ``ffn="mlp"``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import LayerSpec, ModelConfig
from . import attention
from .common import ParamSpec, activation, rms_norm

# where in ROADMAP.md the parts this slice leaves out are queued
_NOT_PORTED = {
    "mamba": "ROADMAP Queue 1, slice 3 (jamba: mamba.py + selective_scan)",
    "mlstm": "ROADMAP Queue 1, modules still missing (xlstm.py)",
    "slstm": "ROADMAP Queue 1, modules still missing (xlstm.py)",
    "moe": "ROADMAP Queue 1, slice 3 (moe.py)",
    "cross_attn": "ROADMAP Queue 1, modules still missing (vlm cross-attention)",
    "window": "ROADMAP Queue 1, modules still missing (sliding-window "
              "ring-buffer KV cache)",
}


def _check_ported(spec: LayerSpec) -> None:
    for part, what in ((spec.mixer, "mixer"), (spec.ffn, "ffn")):
        if part in _NOT_PORTED:
            raise NotImplementedError(
                f"{what}={part!r} is not ported yet: {_NOT_PORTED[part]}")
    if spec.mixer != "attn" or spec.ffn != "mlp":
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
        "mixer": attention.attn_specs(cfg),
        "norm_ffn": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "ffn": mlp_specs(cfg),
    }


def block_apply(params, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                pos: int, cache: Optional[Dict[str, torch.Tensor]],
                mode: str = "prefill") -> torch.Tensor:
    """Pre-norm attention + pre-norm MLP, each with a residual. ``mode``
    (train | prefill | decode) and ``cache`` go to the attention."""
    h = rms_norm(x, params["norm_mixer"], cfg.norm_eps)
    x = x + attention.attn_apply(params["mixer"], h, cfg, pos, cache,
                                 mode=mode)
    h = rms_norm(x, params["norm_ffn"], cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg)
