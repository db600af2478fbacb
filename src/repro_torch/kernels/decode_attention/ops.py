"""Public decode attention: the CUDA kernel on the card, the plain version
on the CPU.

``decode_attention(q, k_cache, v_cache, pos_k, pos_q, window)`` attends one
query position, q (B, 1, K, G, D), against the cache (B, S, K, D) in its
own layout: slots holding positions in ``[0, pos_q]`` are attended, and
with a ``window`` only those above ``pos_q - window``. ``pos_q`` is a 0-d
int32 tensor that stays on the device, so a captured decode step replays
at any position. Returns (B, 1, K, G, D) in the cache's dtype.

A CUDA tensor launches the kernel of :mod:`.kernel` (or raises: there is
no fallback); a CPU tensor takes :mod:`.ref`'s ``naive_attention``, which
a :func:`repro_torch.core.cost.count_cost` tally counts as the kernel
(``cost.stand_in``). Fake tensors (the dry run of
:mod:`repro_torch.launch.dryrun`) take a branch of their own: it allocates
what the kernel allocates (the output alone: the splits combine in shared
memory) and counts the call in ``fake_launches``. ``launches`` counts real
launches, a plain integer on ``decode_attention``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ...core import cost
from . import kernel
from .ref import decode_attention_ref


def _check_args(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos_k: torch.Tensor,
                pos_q: torch.Tensor, window: Optional[int]) -> None:
    if q.dim() != 5 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, K, G, D), got {tuple(q.shape)}")
    B, _, K, G, D = q.shape
    S = k_cache.shape[1] if k_cache.dim() == 4 else -1
    if (k_cache.shape != (B, S, K, D) or v_cache.shape != k_cache.shape
            or S < 1 or pos_k.shape != (S,) or pos_q.numel() != 1):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_cache "
                         f"{tuple(k_cache.shape)} v_cache "
                         f"{tuple(v_cache.shape)} pos_k {tuple(pos_k.shape)} "
                         f"pos_q {tuple(pos_q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if any(t.device != q.device for t in (k_cache, v_cache, pos_k, pos_q)):
        raise ValueError("decode attention takes tensors on one device")
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"decode attention runs on cuda or cpu, not "
                         f"{q.device}")


def _work(q: torch.Tensor, S: int) -> List[Tuple[str, float, float]]:
    """The kernel's :func:`cost.add_kernel` arguments, counted over the S
    allocated slots: an upper bound of its work. A global layer's kernel
    reads only the filled slots, ``min(pos_q + 1, S)``, up to S/(pos + 1)
    fewer bytes, but the position stays on the device, so the tally
    cannot see it."""
    B, _, K, G, D = q.shape
    return [("decode_attention", *cost.decode_attention_work(
        B, S, K * G, K, D, q.element_size()))]


def decode_attention(
    q: torch.Tensor,                   # (B, 1, K, G, D)
    k_cache: torch.Tensor,             # (B, S, K, D)
    v_cache: torch.Tensor,             # (B, S, K, D)
    pos_k: torch.Tensor,               # (S,) positions held in each slot
    pos_q: torch.Tensor,               # 0-d int32: the current position
    window: Optional[int] = None,
) -> torch.Tensor:
    """Returns out (B, 1, K, G, D) in the cache's dtype."""
    _check_args(q, k_cache, v_cache, pos_k, pos_q, window)
    S = k_cache.shape[1]
    if is_fake(q):
        kernel.check(q, k_cache, v_cache, pos_k, pos_q, window)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        decode_attention.fake_launches += 1
        cost.note_reads(q, k_cache, v_cache, pos_k, pos_q)
    elif q.is_cuda:
        out = kernel.decode_attn(q, k_cache, v_cache, pos_k,
                                 pos_q.reshape(()), window)
        decode_attention.launches += 1
    else:
        with cost.stand_in(lambda: _work(q, S)):
            return decode_attention_ref(q, k_cache, v_cache, pos_k, pos_q,
                                        window)
    if cost.counting():
        cost.add_kernel(*_work(q, S)[0])
    return out


decode_attention.launches = 0
decode_attention.fake_launches = 0
