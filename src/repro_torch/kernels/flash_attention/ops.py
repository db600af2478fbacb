"""Public flash attention: the CUDA kernels on the card, the plain versions
on the CPU.

``flash_attention(q, k, v)`` takes model-layout tensors (B, T, H, D) /
(B, S, K, D) (K kv heads, K | H) and returns (out, lse) from the forward
kernel; ``flash_attention_bwd`` returns (dq, dk, dv) from the dq and dk/dv
kernels; :class:`FlashAttention` ties the two into a
``torch.autograd.Function``, the counterpart of the JAX package's
``custom_vjp``. A CUDA tensor launches the kernels of :mod:`.kernel`; a CPU
tensor takes :mod:`.ref`. There is no fallback from one to the other.

Launch counts, plain integers on ``flash_attention``: ``launches``
(forward), ``bwd_dq_launches`` and ``bwd_dkv_launches``; beside them
``launches_by_variant`` (:data:`.kernel.launches_by_variant`) counts each
kernel launch under "<kernel>/<variant>" (``fwd``, ``dq``, ``dkv``;
``wgmma`` or ``scalar``) as the C entry reports the kernel it ran: bf16
inputs run all three on the tensor cores (``wgmma``), f32 inputs on the
scalar f32 kernels; ``launches_by_shape`` counts them under
"<kernel>/<head dim>/<mask>" (``fwd/256/causal``, ``dq/128/non-causal``,
...; a window counts as causal, non-causal is the cross-attention's T
queries against S keys). Inside a
:func:`repro_torch.core.cost.count_cost` block each launch also adds its
FLOPs and bytes, from its shapes.

Fake tensors (``FakeTensorMode``: the dry run of
:mod:`repro_torch.launch.dryrun`, on any device) take a branch of their
own: it returns empty tensors of the kernels' output shapes and dtypes,
adds the kernels' work to the open tallies and counts the call by shape
in ``fake_launches_by_shape``, apart from the real launches, which a dry
run leaves as it found them. A real CPU tensor takes the plain version,
which a tally counts as the kernel (``cost.stand_in``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ...core import cost
from . import kernel
from .ref import flash_attention_bwd_ref, flash_attention_ref


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: Optional[int]) -> None:
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
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def _dims(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, ...]:
    """(B, T, S, H, K, D) of model-layout q and k."""
    B, T, H, D = q.shape
    return B, T, k.shape[1], H, k.shape[2], D


def flash_attention(
    q: torch.Tensor,             # (B, T, H, D)
    k: torch.Tensor,             # (B, S, K, D)
    v: torch.Tensor,             # (B, S, K, D)
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, T, H, D), lse (B, H, T) f32)."""
    _check_args(q, k, v, causal, window)
    key = _shape("fwd", q, causal)

    def work():
        return [("flash_attention_fwd", *cost.attention_work(
            *_dims(q, k), causal, window, q.element_size()), key)]

    if is_fake(q):
        B, T, H, D = q.shape
        out = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device),
               torch.empty((B, H, T), dtype=torch.float32, device=q.device))
        _count_fake(key)
        cost.note_reads(q, k, v)
    elif q.is_cuda:
        out = kernel.flash_fwd(q, k, v, causal=causal, window=window)
        flash_attention.launches += 1
        flash_attention.launches_by_shape[key] += 1
    else:
        with cost.stand_in(work):
            return flash_attention_ref(q, k, v, causal=causal, window=window)
    if cost.counting():
        cost.add_kernel(*work()[0])
    return out


flash_attention.launches = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0
flash_attention.launches_by_variant = kernel.launches_by_variant
flash_attention.launches_by_shape = {
    f"{name}/{D}/{mask}": 0 for name, dims in kernel.HEAD_DIMS.items()
    for D in dims for mask in ("causal", "non-causal")}
flash_attention.fake_launches_by_shape = dict.fromkeys(
    flash_attention.launches_by_shape, 0)


def _count_fake(key: str) -> None:
    fake = flash_attention.fake_launches_by_shape
    fake[key] = fake.get(key, 0) + 1


def _shape(name: str, q: torch.Tensor, causal: bool) -> str:
    return f"{name}/{q.shape[-1]}/{'causal' if causal else 'non-causal'}"


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    out: torch.Tensor,           # (B, T, H, D), the forward's output
    lse: torch.Tensor,           # (B, H, T) f32, the forward's logsumexp
    do: torch.Tensor,            # (B, T, H, D), the gradient of out
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq (B, T, H, D), dk, dv (B, S, K, D)) in the inputs' dtypes."""
    _check_args(q, k, v, causal, window)
    keys = {"dq": _shape("dq", q, causal), "dkv": _shape("dkv", q, causal)}

    def work():
        w = cost.backward_work(*_dims(q, k), causal, window, q.element_size())
        return [(f"flash_attention_bwd_{n}", *w[n], keys[n])
                for n in ("dq", "dkv")]

    fake = is_fake(q)
    if not q.is_cuda and not fake:
        with cost.stand_in(work):
            return flash_attention_bwd_ref(q, k, v, out, lse, do,
                                           causal=causal, window=window)
    do = do.contiguous()
    # one f32 reduction outside the kernels, as the JAX package's jnp one
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    if fake:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
        dv = torch.empty(k.shape, dtype=k.dtype, device=q.device)
        for key in keys.values():
            _count_fake(key)
        cost.note_reads(q, k, v, do, lse, delta)
    else:
        dq = kernel.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                 window=window)
        flash_attention.bwd_dq_launches += 1
        flash_attention.launches_by_shape[keys["dq"]] += 1
        dk, dv = kernel.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                      window=window)
        flash_attention.bwd_dkv_launches += 1
        flash_attention.launches_by_shape[keys["dkv"]] += 1
    if cost.counting():
        for args in work():
            cost.add_kernel(*args)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, window)`` -> (out, lse), with
    the backward kernels as its gradient. ``lse`` is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                window: Optional[int] = None):
        out, lse = flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
