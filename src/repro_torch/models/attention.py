"""Attention: GQA + RoPE (+ qk-norm), port of ``repro.models.attention``.

Prefill and training attention go through the flash-attention kernels of
:mod:`repro_torch.kernels.flash_attention.ops` (the CUDA kernels on the
card, their plain versions on the CPU); training differentiates through
them with :class:`~repro_torch.kernels.flash_attention.ops.FlashAttention`.
Decode attends one query against the KV cache in plain torch, as the JAX
package does in plain jnp.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
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
) -> torch.Tensor:
    """Materialized-score attention over explicit positions; keys at a
    negative position (empty cache slots) are masked."""
    D = q.shape[-1]
    scores = torch.einsum("btkgd,bskd->bkgts", q, k).float() / math.sqrt(D)
    mask = pos_k[None, :] >= 0
    if causal:
        mask = mask & (pos_k[None, :] <= pos_q[:, None])
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)


def decode_attention(
    q: torch.Tensor,                   # (B, 1, K, G, D)
    k_cache: torch.Tensor,             # (B, S, K, D)
    v_cache: torch.Tensor,             # (B, S, K, D)
    pos_k: torch.Tensor,               # (S,) positions held in each slot
    pos_q: int,                        # current position
) -> torch.Tensor:
    """One query position against the cache: slots holding positions in
    ``[0, pos_q]`` are attended."""
    pq = torch.full((1,), pos_q, dtype=torch.int32, device=q.device)
    return naive_attention(q, k_cache, v_cache, pq, pos_k, causal=True)


def attn_apply(
    params,
    x: torch.Tensor,                   # (B, T, E)
    cfg: ModelConfig,
    pos: int,                          # first position of x
    cache: Optional[Dict[str, torch.Tensor]],
    mode: str = "prefill",             # train | prefill | decode
) -> torch.Tensor:
    """Self-attention sublayer; returns the sublayer output. Prefill and
    decode write this call's keys and values into ``cache``; train uses
    no cache and is differentiable.

    The cache ({"k", "v": (B, S, K, D), "pos": (S,) int32, -1 = empty}) is
    preallocated to its full serving length and updated in place, where
    the JAX package returns a new cache from a functional update and
    donates the old one. Prefill fills slots ``[0, T)``; a decode step at
    position ``pos`` writes slot ``min(pos, S - 1)``.
    """
    B, T, E = x.shape
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    q = (x @ params["wq"]).view(B, T, H, D)
    k = (x @ params["wk"]).view(B, T, K, D)
    v = (x @ params["wv"]).view(B, T, K, D)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    positions = torch.arange(pos, pos + T, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "train":
        if pos != 0:
            raise ValueError("train starts at position 0")
        out, _lse = FlashAttention.apply(q, k, v, True, None)
    elif mode == "decode":
        S = cache["k"].shape[1]
        slot = min(pos, S - 1)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["pos"][slot] = pos
        out = decode_attention(q.view(B, 1, K, G, D), cache["k"], cache["v"],
                               cache["pos"], pos)
    elif mode == "prefill":
        if pos != 0:
            raise ValueError("prefill starts at position 0")
        cache["k"][:, :T] = k
        cache["v"][:, :T] = v
        cache["pos"][:T] = positions
        out, _lse = flash_attention(q, k, v, causal=True)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out.reshape(B, T, H * D) @ params["wo"]


def alloc_cache(cfg: ModelConfig, batch: int, seq_len: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty KV cache of one attention sublayer (all slots at pos -1)."""
    K, D = cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)
    return {
        "k": torch.zeros((batch, seq_len, K, D), dtype=dt, device=device),
        "v": torch.zeros((batch, seq_len, K, D), dtype=dt, device=device),
        "pos": torch.full((seq_len,), -1, dtype=torch.int32, device=device),
    }
