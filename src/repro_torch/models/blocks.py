"""One pattern position = pre-norm mixer + FFN (port of ``repro.models.blocks``).

Mixers ``attn`` (global or sliding-window), ``mamba``, ``mlstm`` and
``slstm``; FFNs ``mlp``, ``moe`` and ``none`` (the xLSTM blocks carry
their own feed-forward).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import LayerSpec, ModelConfig
from . import attention, mamba, moe, xlstm
from .common import ParamSpec, activation, rms_norm

_MIXER_SPECS = {
    "attn": attention.attn_specs,
    "mamba": mamba.mamba_specs,
    "mlstm": xlstm.mlstm_specs,
    "slstm": xlstm.slstm_specs,
}
_FFNS = ("mlp", "moe", "none")


def _check_ported(spec: LayerSpec) -> None:
    """Raise for the layer kinds not ported yet, naming where ROADMAP.md
    queues them."""
    if spec.cross_attn:
        raise NotImplementedError(
            "cross_attn is not ported yet: ROADMAP Queue 1, item 7 (vlm "
            "cross-attention)")
    if spec.mixer not in _MIXER_SPECS or spec.ffn not in _FFNS:
        raise NotImplementedError(
            f"layer {spec} is not ported yet: ROADMAP Queue 1, item 7")


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
    out: Dict[str, Any] = {
        "norm_mixer": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "mixer": _MIXER_SPECS[spec.mixer](cfg),
    }
    if spec.ffn != "none":
        out["norm_ffn"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
        out["ffn"] = mlp_specs(cfg) if spec.ffn == "mlp" else moe.moe_specs(cfg)
    return out


def alloc_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq_len: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty decode cache of one layer's mixer (``block_cache_specs``),
    sized from its own ``spec``: a KV cache for attention (at most
    ``window`` slots for a windowed layer), the recurrent state for
    mamba, mLSTM and sLSTM."""
    if spec.mixer == "attn":
        return attention.alloc_cache(cfg, spec, batch, seq_len, device)
    if spec.mixer == "mamba":
        return mamba.alloc_cache(cfg, batch, device)
    if spec.mixer == "mlstm":
        return xlstm.mlstm_alloc_cache(cfg, batch, device)
    return xlstm.slstm_alloc_cache(cfg, batch, device)


def block_apply(params, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                pos, cache: Optional[Dict[str, torch.Tensor]],
                mode: str = "prefill"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-norm mixer + pre-norm FFN, each with a residual. ``mode``
    (train | prefill | decode), ``pos`` (an int, or in decode a 0-d tensor
    on the device) and ``cache`` go to the mixer. Returns (x, aux), aux
    the MoE stats (empty for an MLP or no FFN)."""
    h = rms_norm(x, params["norm_mixer"], cfg.norm_eps)
    if spec.mixer == "attn":
        out = attention.attn_apply(params["mixer"], h, cfg, spec, pos, cache,
                                   mode=mode)
    elif spec.mixer == "mamba":
        out = mamba.mamba_apply(params["mixer"], h, cfg, cache, mode=mode)
    elif spec.mixer == "mlstm":
        out = xlstm.mlstm_apply(params["mixer"], h, cfg, cache, mode=mode)
    else:
        # the sLSTM block is self-contained (its own MLP and residual)
        out = xlstm.slstm_apply(params["mixer"], h, cfg, cache, mode=mode)
    x = x + out
    if spec.ffn == "none":
        return x, {}
    h = rms_norm(x, params["norm_ffn"], cfg.norm_eps)
    if spec.ffn == "mlp":
        return x + mlp_apply(params["ffn"], h, cfg), {}
    out, aux = moe.moe_apply(params["ffn"], h, cfg)
    return x + out, aux
