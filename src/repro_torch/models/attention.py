"""Attention: GQA + RoPE (+ qk-norm), port of ``repro.models.attention``.

Prefill and training attention go through the flash-attention kernels of
:mod:`repro_torch.kernels.flash_attention.ops` (the CUDA kernels on the
card, their plain versions on the CPU); training differentiates through
them with :class:`~repro_torch.kernels.flash_attention.ops.FlashAttention`.
Decode attends one query against the KV cache in plain torch, as the JAX
package does in plain jnp, at a position that may stay on the device
(a 0-d tensor), so that a captured decode step replays at any position.
Sliding-window layers keep a ring-buffer cache of at most ``window``
slots. The gated cross-attention sublayer of the vlm family attends from
the text positions to precomputed encoder embeddings, non-causal and
without RoPE, through the same kernels.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..configs.base import LayerSpec, ModelConfig
from ..kernels.flash_attention.ops import FlashAttention, flash_attention
from .common import ParamSpec, apply_rope, rms_norm

NEG_INF = -2.0e38


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    E, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((E, H * D), ("embed", "heads")),
        "wk": ParamSpec((E, K * D), ("embed", "kv_heads")),
        "wv": ParamSpec((E, K * D), ("embed", "kv_heads")),
        "wo": ParamSpec((H * D, E), ("heads", "embed"), init="scaled", scale=1.0),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((D,), (None,), init="zeros")
        specs["k_norm"] = ParamSpec((D,), (None,), init="zeros")
    return specs


def naive_attention(
    q: torch.Tensor,                   # (B, T, K, G, D)
    k: torch.Tensor,                   # (B, S, K, D)
    v: torch.Tensor,                   # (B, S, K, D)
    pos_q: torch.Tensor,               # (T,)
    pos_k: torch.Tensor,               # (S,); -1 marks an empty cache slot
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Materialized-score attention over explicit positions; keys at a
    negative position (empty cache slots) are masked, and with a
    ``window`` so are keys ``window`` or more positions behind the
    query."""
    D = q.shape[-1]
    scores = torch.einsum("btkgd,bskd->bkgts", q, k).float() / math.sqrt(D)
    mask = pos_k[None, :] >= 0
    if causal:
        mask = mask & (pos_k[None, :] <= pos_q[:, None])
    if window is not None:
        mask = mask & (pos_k[None, :] > pos_q[:, None] - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)


def decode_attention(
    q: torch.Tensor,                   # (B, 1, K, G, D)
    k_cache: torch.Tensor,             # (B, S, K, D)
    v_cache: torch.Tensor,             # (B, S, K, D)
    pos_k: torch.Tensor,               # (S,) positions held in each slot
    pos_q: torch.Tensor,               # 0-d int32: the current position
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query position against the cache: slots holding positions in
    ``[0, pos_q]`` are attended, and with a ``window`` only those above
    ``pos_q - window``. ``pos_q`` stays on the device: nothing here reads
    it back to the host, so a captured step replays at any position."""
    return naive_attention(q, k_cache, v_cache, pos_q.reshape(1), pos_k,
                           causal=True, window=window)


def device_pos(pos, device: torch.device) -> torch.Tensor:
    """``pos`` (a Python int or a 0-d integer tensor) as a 0-d int32
    tensor on ``device``; an int is filled in on the device, with no copy
    from the host."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), pos, dtype=torch.int32, device=device)


def attn_apply(
    params,
    x: torch.Tensor,                   # (B, T, E)
    cfg: ModelConfig,
    spec: LayerSpec,
    pos,                               # first position of x: int, or 0-d tensor
    cache: Optional[Dict[str, torch.Tensor]],
    mode: str = "prefill",             # train | prefill | decode
) -> torch.Tensor:
    """Self-attention sublayer; returns the sublayer output. Prefill and
    decode write this call's keys and values into ``cache``; train uses
    no cache and is differentiable. ``spec.window`` makes the layer
    attend only the last ``window`` positions.

    The cache ({"k", "v": (B, S, K, D), "pos": (S,) int32, -1 = empty}) is
    preallocated (:func:`alloc_cache`) and updated in place, where the
    JAX package returns a new cache from a functional update and donates
    the old one. Prefill writes position ``p`` to slot ``p`` (a global
    layer) or ``p % S`` (a windowed layer's ring, which keeps the last
    ``S`` positions of a longer prompt). A decode step at position ``pos``
    writes slot ``min(pos, S - 1)`` (global) or ``pos % S`` (windowed),
    computed on the device: ``pos`` may be a 0-d int tensor there, and
    decode never reads it back to the host.

    A windowed layer's cache holds ``min(P + G, window)`` slots, where
    the JAX serve loop grows a prefill cache of ``P <= window`` slots to
    ``P + G``. The slot order differs, but the attended set does not: a
    position that the ring overwrites is ``window`` behind the query, and
    the window's mask excludes it in both.
    """
    B, T, E = x.shape
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    window = spec.window
    q = (x @ params["wq"]).view(B, T, H, D)
    k = (x @ params["wk"]).view(B, T, K, D)
    v = (x @ params["wv"]).view(B, T, K, D)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    if mode == "decode":
        pos_q = device_pos(pos, x.device)
        positions = pos_q.reshape(1)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        S = cache["k"].shape[1]
        slot = (pos_q % S if window is not None
                else pos_q.clamp(max=S - 1)).reshape(1).long()
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        cache["pos"].index_copy_(0, slot, positions)
        out = decode_attention(q.view(B, 1, K, G, D), cache["k"], cache["v"],
                               cache["pos"], pos_q, window=window)
        return out.reshape(B, T, H * D) @ params["wo"]
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    if pos != 0:
        raise ValueError(f"{mode} starts at position 0")
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "train":
        out, _lse = FlashAttention.apply(q, k, v, True, window)
    else:
        S = cache["k"].shape[1]
        if T <= S:
            cache["k"][:, :T] = k
            cache["v"][:, :T] = v
            cache["pos"][:T] = positions
        elif window is not None:
            # the ring keeps the last S positions, position p at slot p % S
            slots = positions[T - S:].long() % S
            cache["k"].index_copy_(1, slots, k[:, T - S:])
            cache["v"].index_copy_(1, slots, v[:, T - S:])
            cache["pos"].index_copy_(0, slots, positions[T - S:])
        else:
            raise ValueError(f"a prompt of {T} positions does not fit a "
                             f"global layer's cache of {S} slots")
        out, _lse = flash_attention(q, k, v, causal=True, window=window)
    return out.reshape(B, T, H * D) @ params["wo"]


def alloc_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq_len: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty KV cache of one attention sublayer for ``seq_len`` positions
    (all slots at pos -1): ``seq_len`` slots for a global layer, at most
    ``window`` for a windowed one (the reference's ``cache_specs``)."""
    K, D = cfg.n_kv_heads, cfg.head_dim
    if spec.window is not None:
        seq_len = min(seq_len, spec.window)
    dt = getattr(torch, cfg.dtype)
    return {
        "k": torch.zeros((batch, seq_len, K, D), dtype=dt, device=device),
        "v": torch.zeros((batch, seq_len, K, D), dtype=dt, device=device),
        "pos": torch.full((seq_len,), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# cross-attention sublayer (vlm): kv from precomputed encoder embeddings
# ---------------------------------------------------------------------------

def cross_attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    specs = attn_specs(cfg)
    specs["gate"] = ParamSpec((), (), init="zeros")   # gated cross-attn (llama3.2)
    return specs


def build_cross_kv(params, enc: torch.Tensor, cfg: ModelConfig
                   ) -> Dict[str, torch.Tensor]:
    """Keys and values (B, N, K, D) of the encoder embeddings ``enc`` (B,
    N, E): no RoPE, the keys qk-normed when the config has it."""
    B, N, _ = enc.shape
    K, D = cfg.n_kv_heads, cfg.head_dim
    k = (enc @ params["wk"]).view(B, N, K, D)
    v = (enc @ params["wv"]).view(B, N, K, D)
    if cfg.qk_norm:
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return {"k": k, "v": v}


def _cross_q(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, T, _ = x.shape
    q = (x @ params["wq"]).view(B, T, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
    return q


def _gated_out(params, out: torch.Tensor) -> torch.Tensor:
    """``tanh(gate) * (out @ wo)``, the gate (an f32 scalar) cast to the
    output's dtype as the JAX package casts it."""
    B, T = out.shape[:2]
    out = out.reshape(B, T, -1) @ params["wo"]
    return torch.tanh(params["gate"]).to(out.dtype) * out


def cross_attn_apply(params, x: torch.Tensor, enc: Optional[torch.Tensor],
                     cfg: ModelConfig,
                     cache: Optional[Dict[str, torch.Tensor]] = None,
                     mode: str = "prefill") -> torch.Tensor:
    """Gated cross-attention of ``x`` (B, T, E) over the encoder
    embeddings ``enc`` (B, N, E): every query attends every encoder
    position. Train and prefill run the flash kernels non-causal (T
    queries against N keys); prefill also writes the encoder's keys and
    values into ``cache`` ({"k", "v": (B, N, K, D)}, :func:`alloc_cross_kv`),
    which decode reads instead of ``enc`` (:func:`cross_from_cache`)."""
    if mode == "decode":
        return cross_from_cache(params, x, cache, cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    q = _cross_q(params, x, cfg)
    kv = build_cross_kv(params, enc, cfg)
    if mode == "train":
        out, _lse = FlashAttention.apply(q, kv["k"], kv["v"], False, None)
    else:
        cache["k"].copy_(kv["k"])
        cache["v"].copy_(kv["v"])
        out, _lse = flash_attention(q, kv["k"], kv["v"], causal=False)
    return _gated_out(params, out)


def cross_from_cache(params, x: torch.Tensor, kv: Dict[str, torch.Tensor],
                     cfg: ModelConfig) -> torch.Tensor:
    """One decode position (B, 1, E) against the cached encoder keys and
    values, every one of the N slots valid: the query's position is 2**30,
    as in the JAX package, a 0-d tensor filled in on the device."""
    B, T, _ = x.shape
    K = cfg.n_kv_heads
    q = _cross_q(params, x, cfg)
    q = q.view(B, T, K, cfg.n_heads // K, cfg.head_dim)
    N = kv["k"].shape[1]
    pos_k = torch.arange(N, dtype=torch.int32, device=x.device)
    out = decode_attention(q, kv["k"], kv["v"], pos_k,
                           device_pos(2 ** 30, x.device))
    return _gated_out(params, out)


def alloc_cross_kv(cfg: ModelConfig, batch: int, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """The cross-attention cache of one layer: the encoder's keys and values
    (B, encoder_len, K, D) in the compute dtype, written by prefill."""
    shape = (batch, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
