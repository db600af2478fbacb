"""Public selective scan: the CUDA kernels on the card, the plain version on
the CPU.

``selective_scan(x, dt, A, Bc, Cc, D)`` takes the model layout of
``repro.kernels.mamba_scan``: x, dt (B, T, dI), A (dI, N), Bc, Cc
(B, T, N), D (dI,). A CUDA tensor launches the kernel of :mod:`.kernel`;
a CPU tensor takes :mod:`.ref`. There is no fallback from one to the
other. When an input needs a gradient the call goes through
:class:`SelectiveScan`, whose backward on the card is the backward kernel;
otherwise (serving) it runs the forward kernel alone and saves nothing.

Launch counts, plain integers on ``selective_scan``: ``launches`` (the
forward kernel) and ``bwd_launches`` (the backward kernel). Inside a
:func:`repro_torch.core.cost.count_cost` block each launch also adds its
FLOPs and bytes, from its shapes.

Fake tensors (``FakeTensorMode``: the dry run of
:mod:`repro_torch.launch.dryrun`, on any device) take a branch of their
own: it returns empty tensors of the kernels' output shapes and dtypes
(the training forward's saved states among them, which the card keeps
until the backward, so that a dry run's memory holds them), adds the
kernels' work to the open tallies and counts the call in
``fake_launches`` and ``fake_bwd_launches``, apart from the real
launches, which a dry run leaves as it found them. A real CPU tensor
takes the plain version, which a tally counts as the kernel
(``cost.stand_in``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch._subclasses.fake_tensor import is_fake

from ...core import cost
from . import kernel
from .ref import selective_scan_bwd_ref, selective_scan_ref


def _work(x, dt, A, chunks: int):
    """The forward kernel's :func:`cost.add_kernel` arguments."""
    B, T, dI = x.shape
    flops, _exps, nbytes = cost.scan_work(
        B, T, dI, A.shape[1], x.element_size(), dt.element_size(), chunks)
    return [("selective_scan", flops, nbytes)]


def _bwd_work(x, dt, A):
    """The backward kernel's :func:`cost.add_kernel` arguments."""
    B, T, dI = x.shape
    flops, _exps, nbytes = cost.scan_bwd_work(
        B, T, dI, A.shape[1], x.element_size(), dt.element_size(),
        kernel.n_chunks(T))
    return [("selective_scan_bwd", flops, nbytes)]


def _forward(x, dt, A, Bc, Cc, D, return_state: bool, train: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                        Optional[torch.Tensor]]:
    """(y in x's dtype, final state or None, saved states or None): the
    forward kernel on CUDA tensors, the fake branch on fake tensors, the
    plain version on CPU tensors (which saves no states: its backward
    recomputes through autograd, and a tally counts the states the card
    would save). ``train``: the call saves its states for the backward."""
    B, T, dI = x.shape
    N = A.shape[1]
    saved = kernel.n_chunks(T) if train else 0
    if is_fake(x):
        y = torch.empty((B, T, dI), dtype=x.dtype, device=x.device)
        h = (torch.empty((B, dI, N), dtype=torch.float32, device=x.device)
             if return_state else None)
        chunks = (torch.empty((B, saved, dI, N), dtype=torch.float32,
                              device=x.device) if train else None)
        selective_scan.fake_launches += 1
        cost.note_reads(x, dt, A, Bc, Cc, D)
    elif x.is_cuda:
        y, h, chunks = kernel.selective_scan(
            x, dt, A, Bc, Cc, D, return_state=return_state, save_chunks=train)
        selective_scan.launches += 1
    elif x.device.type == "cpu":
        with cost.stand_in(lambda: _work(x, dt, A, saved)):
            y, h = selective_scan_ref(x, dt, A, Bc, Cc, D)
            return y.to(x.dtype), h, None
    else:
        raise ValueError(f"selective_scan runs on cuda or cpu, not {x.device}")
    if cost.counting():
        cost.add_kernel(*_work(x, dt, A, saved)[0])
    return y, h, chunks


class SelectiveScan(torch.autograd.Function):
    """``SelectiveScan.apply(x, dt, A, Bc, Cc, D)`` -> (y, final state),
    with the gradients of y as its backward: on CUDA tensors the forward
    kernel saves its state every ``kernel.SAVE_EVERY`` steps and the
    backward kernel reads them; on CPU tensors the plain version runs both
    ways; fake tensors take the fake branch both ways. The final state is
    not differentiable."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, D):
        y, h, chunks = _forward(x, dt, A, Bc, Cc, D, return_state=True,
                                train=True)
        ctx.save_for_backward(x, dt, A, Bc, Cc, D, chunks)
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, dy, _dh):
        x, dt, A, Bc, Cc, D, chunks = ctx.saved_tensors
        if is_fake(x):
            grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                          for t in (x, dt, A, Bc, Cc, D))
            selective_scan.fake_bwd_launches += 1
            cost.note_reads(x, dt, A, Bc, Cc, D, dy, *(
                () if chunks is None else (chunks,)))
        elif x.is_cuda:
            grads = kernel.selective_scan_bwd(x, dt, A, Bc, Cc, D, dy, chunks)
            selective_scan.bwd_launches += 1
        else:
            with cost.stand_in(lambda: _bwd_work(x, dt, A)):
                return selective_scan_bwd_ref(x, dt, A, Bc, Cc, D, dy)
        if cost.counting():
            cost.add_kernel(*_bwd_work(x, dt, A)[0])
        return grads


def selective_scan(
    x: torch.Tensor,             # (B, T, dI)
    dt: torch.Tensor,            # (B, T, dI)
    A: torch.Tensor,             # (dI, N) f32
    Bc: torch.Tensor,            # (B, T, N)
    Cc: torch.Tensor,            # (B, T, N)
    D: torch.Tensor,             # (dI,) f32
    return_state: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns y (B, T, dI) in x's dtype, and with ``return_state`` also
    the final state (B, dI, N) f32."""
    if x.dim() != 3 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, T >= 1, dI), got {tuple(x.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bc, Cc, D)):
        y, h = SelectiveScan.apply(x, dt, A, Bc, Cc, D)
    else:
        y, h, _ = _forward(x, dt, A, Bc, Cc, D, return_state, False)
    return (y, h) if return_state else y


selective_scan.launches = 0
selective_scan.bwd_launches = 0
selective_scan.fake_launches = 0
selective_scan.fake_bwd_launches = 0
