"""Plain PyTorch version of the flash-attention forward kernel.

Materialized scores, as ``repro.kernels.flash_attention.ref.mha_reference``,
but in the kernel's arithmetic: scores, softmax and the P·V sum in f32,
GQA by kv head ``h // (H/K)``, and the row logsumexp returned beside the
output. The CPU path of :func:`..ops.flash_attention` and the yardstick the
CUDA kernel is held to on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def flash_attention_ref(
    q: torch.Tensor,             # (B, T, H, D)
    k: torch.Tensor,             # (B, S, K, D), K | H
    v: torch.Tensor,             # (B, S, K, D)
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, T, H, D) in q's dtype, lse (B, H, T) f32)."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    rep = H // K
    kx = k.float().repeat_interleave(rep, dim=2)
    vx = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kx) * scale
    pos_q = torch.arange(T, device=q.device)[:, None]
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_k <= pos_q
    if window is not None:
        mask &= pos_k > pos_q - window
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                               # (B, H, T)
    # a fully masked row has lse = -inf: give it p = 0 (out 0), not NaN
    p = torch.exp(s - torch.nan_to_num(lse, neginf=0.0)[..., None])
    out = torch.einsum("bhts,bshd->bthd", p, vx)
    return out.to(q.dtype), lse
