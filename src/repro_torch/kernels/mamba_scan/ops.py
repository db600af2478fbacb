"""Public selective scan: the CUDA kernel on the card, the plain version on
the CPU.

``selective_scan(x, dt, A, Bc, Cc, D)`` takes the model layout of
``repro.kernels.mamba_scan``: x, dt (B, T, dI), A (dI, N), Bc, Cc
(B, T, N), D (dI,). A CUDA tensor launches the kernel of :mod:`.kernel`;
a CPU tensor takes :mod:`.ref`. There is no fallback from one to the
other. ``selective_scan.launches`` counts the kernel's launches; inside a
:func:`repro_torch.core.cost.count_cost` block each launch also adds its
FLOPs and bytes, from its shapes.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from ...core import cost
from . import kernel
from .ref import selective_scan_ref


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
    if x.is_cuda:
        y, h = kernel.selective_scan(x, dt, A, Bc, Cc, D,
                                     return_state=return_state)
        selective_scan.launches += 1
        if cost.counting():
            B, T, dI = x.shape
            flops, _exps, nbytes = cost.scan_work(
                B, T, dI, A.shape[1], x.element_size(), dt.element_size())
            cost.add_kernel("selective_scan", flops, nbytes)
    elif x.device.type == "cpu":
        y, h = selective_scan_ref(x, dt, A, Bc, Cc, D)
        y = y.to(x.dtype)
    else:
        raise ValueError(f"selective_scan runs on cuda or cpu, not {x.device}")
    return (y, h) if return_state else y


selective_scan.launches = 0
