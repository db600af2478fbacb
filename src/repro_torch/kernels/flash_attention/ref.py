"""Plain PyTorch versions of the flash-attention kernels.

Materialized scores, as ``repro.kernels.flash_attention.ref.mha_reference``,
but in the kernels' arithmetic: scores, softmax and every product in f32,
GQA by kv head ``h // (H/K)``. The forward returns the row logsumexp beside
the output; the backward recomputes p from it. They are the CPU path of
:mod:`..ops` and the yardsticks the CUDA kernels are held to on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _mask(T: int, S: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(T, S) bool: True where query t may attend key s."""
    pos_q = torch.arange(T, device=device)[:, None]
    pos_k = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= pos_k <= pos_q
    if window is not None:
        mask &= pos_k > pos_q - window
    return mask


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
    s = s.masked_fill(~_mask(T, S, causal, window, q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                               # (B, H, T)
    # a fully masked row has lse = -inf: give it p = 0 (out 0), not NaN
    p = torch.exp(s - torch.nan_to_num(lse, neginf=0.0)[..., None])
    out = torch.einsum("bhts,bshd->bthd", p, vx)
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(
    q: torch.Tensor,             # (B, T, H, D)
    k: torch.Tensor,             # (B, S, K, D), K | H
    v: torch.Tensor,             # (B, S, K, D)
    out: torch.Tensor,           # (B, T, H, D), the forward's stored output
    lse: torch.Tensor,           # (B, H, T) f32
    do: torch.Tensor,            # (B, T, H, D)
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq (B, T, H, D) in q's dtype, dk and dv (B, S, K, D) in k's
    dtype): p recomputed from ``lse``, delta = rowsum(do * out) from the
    stored ``out``, f32 throughout, and dk, dv summed over the H/K query
    heads of each kv head."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    rep = H // K
    qf, dof = q.float(), do.float()
    kx = k.float().repeat_interleave(rep, dim=2)
    vx = v.float().repeat_interleave(rep, dim=2)
    allowed = _mask(T, S, causal, window, q.device) & torch.isfinite(
        lse)[..., None]                                            # (B,H,T,S)
    s = torch.einsum("bthd,bshd->bhts", qf, kx) * scale
    # masked pairs and rows with lse = -inf get p = 0, never exp(-inf + inf)
    p = torch.where(allowed, torch.exp(s - torch.nan_to_num(
        lse, neginf=0.0)[..., None]), torch.zeros((), device=q.device))
    delta = (dof * out.float()).sum(-1).transpose(1, 2)            # (B, H, T)
    dp = torch.einsum("bthd,bshd->bhts", dof, vx)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, kx)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf).view(B, S, K, rep, D).sum(3)
    dv = torch.einsum("bhts,bthd->bshd", p, dof).view(B, S, K, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
