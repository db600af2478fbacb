"""Public flash-attention forward: the CUDA kernel on the card, the plain
version on the CPU.

``flash_attention(q, k, v)`` takes model-layout tensors (B, T, H, D) /
(B, S, K, D) (K kv heads, K | H). A CUDA tensor launches the kernel of
:mod:`.kernel`; a CPU tensor takes :func:`.ref.flash_attention_ref`.
There is no fallback from one to the other. ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,             # (B, T, H, D)
    k: torch.Tensor,             # (B, S, K, D)
    v: torch.Tensor,             # (B, S, K, D)
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, T, H, D), lse (B, H, T) f32)."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    # the causal mask compares positions from 0 on both sides (prefill)
    if causal and T != S:
        raise ValueError(f"causal attention needs T == S, got {T} and {S}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.is_cuda:
        out = kernel.flash_fwd(q, k, v, causal=causal, window=window)
        flash_attention.launches += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
