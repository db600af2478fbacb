"""Plain PyTorch attention over explicit positions: decode attention's CPU
path and the reference its kernel is held to (port of the JAX package's
``repro.models.attention.naive_attention``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


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


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos_k: torch.Tensor,
                         pos_q: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """One query position (q (B, 1, K, G, D)) at ``pos_q`` (0-d) against
    the cache: :func:`naive_attention`, causal."""
    return naive_attention(q, k_cache, v_cache, pos_q.reshape(1), pos_k,
                           causal=True, window=window)
