"""One pattern position = pre-norm mixer + (optional gated cross-attention)
+ FFN (port of ``repro.models.blocks``).

Mixers ``attn`` (global or sliding-window), ``mamba``, ``mlstm`` and
``slstm``; FFNs ``mlp``, ``moe`` and ``none`` (the xLSTM blocks carry
their own feed-forward). The reference's mixer ``none`` is not ported:
no configuration has a layer without a mixer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import LayerSpec, ModelConfig
from ..sharding.rules import constrain, grad_constrained
from . import attention, mamba, moe, xlstm
from .common import ParamSpec, activation, rms_norm

_MIXER_SPECS = {
    "attn": attention.attn_specs,
    "mamba": mamba.mamba_specs,
    "mlstm": xlstm.mlstm_specs,
    "slstm": xlstm.slstm_specs,
}
_FFNS = ("mlp", "moe", "none")


def _check_known(spec: LayerSpec) -> None:
    """Raise ValueError for a mixer or FFN that the port does not have."""
    if spec.mixer not in _MIXER_SPECS:
        raise ValueError(f"unknown mixer {spec.mixer!r} in {spec}")
    if spec.ffn not in _FFNS:
        raise ValueError(f"unknown ffn {spec.ffn!r} in {spec}")


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
    _check_known(spec)
    out: Dict[str, Any] = {
        "norm_mixer": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "mixer": _MIXER_SPECS[spec.mixer](cfg),
    }
    if spec.cross_attn:
        out["norm_cross"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
        out["cross"] = attention.cross_attn_specs(cfg)
    if spec.ffn != "none":
        out["norm_ffn"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
        out["ffn"] = mlp_specs(cfg) if spec.ffn == "mlp" else moe.moe_specs(cfg)
    return out


def alloc_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq_len: int,
                device: torch.device) -> Dict[str, Any]:
    """Empty decode cache of one layer (``block_cache_specs``), sized from
    its own ``spec``: the mixer's (a KV cache for attention, at most
    ``window`` slots for a windowed layer; the recurrent state for mamba,
    mLSTM and sLSTM), and under ``cross_kv`` the
    encoder's keys and values of a cross-attention layer."""
    if spec.mixer == "attn":
        out = attention.alloc_cache(cfg, spec, batch, seq_len, device)
    elif spec.mixer == "mamba":
        out = mamba.alloc_cache(cfg, batch, device)
    elif spec.mixer == "mlstm":
        out = xlstm.mlstm_alloc_cache(cfg, batch, device)
    else:
        out = xlstm.slstm_alloc_cache(cfg, batch, device)
    if spec.cross_attn:
        out["cross_kv"] = attention.alloc_cross_kv(cfg, batch, device)
    return out


def _seq_whole(h: torch.Tensor) -> torch.Tensor:
    return constrain(h, ("batch", None, None))


def _seq_whole_grad(out: torch.Tensor) -> torch.Tensor:
    """A sublayer's output, whose gradient from the residual stream gathers
    the sequence before the projections' backward folds (B, T)."""
    return grad_constrained(out, ("batch", None, None))


def block_apply(params, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                pos, cache: Optional[Dict[str, Any]], mode: str = "prefill",
                enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-norm mixer, pre-norm cross-attention over the encoder
    embeddings ``enc`` (a cross-attention layer), pre-norm FFN, each with
    a residual. ``mode`` (train | prefill | decode), ``pos`` (an int, or
    in decode a 0-d tensor on the device) and ``cache`` go to the mixer;
    prefill writes ``cache["cross_kv"]`` and decode reads it in place of
    ``enc``. Returns (x, aux), aux the MoE stats (empty for an MLP or no
    FFN). Under a mesh the residual stream may be split over the sequence
    (``act_seq``); each normed input gathers it before the sublayer's
    projections (the Megatron-SP boundary: DTensor folds (B, T) into the
    rows of a matmul only when T is whole)."""
    h = _seq_whole(rms_norm(x, params["norm_mixer"], cfg.norm_eps))
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
    x = x + _seq_whole_grad(out)
    if spec.cross_attn:
        h = _seq_whole(rms_norm(x, params["norm_cross"], cfg.norm_eps))
        x = x + _seq_whole_grad(attention.cross_attn_apply(
            params["cross"], h, enc, cfg,
            None if cache is None else cache["cross_kv"], mode=mode))
    if spec.ffn == "none":
        return x, {}
    h = _seq_whole(rms_norm(x, params["norm_ffn"], cfg.norm_eps))
    if spec.ffn == "mlp":
        return x + _seq_whole_grad(mlp_apply(params["ffn"], h, cfg)), {}
    out, aux = moe.moe_apply(params["ffn"], h, cfg)
    return x + _seq_whole_grad(out), aux
