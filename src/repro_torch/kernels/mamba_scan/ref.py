"""Plain PyTorch selective scan: a sequential loop over time in f32, the
counterpart of ``repro.kernels.mamba_scan.ref.selective_scan_reference``.

It is the CPU path of :mod:`.ops` and the yardstick the CUDA kernel is held
to on the card. Like the JAX reference it returns y in f32, before the
kernel's rounding to x's dtype; beside y it returns the final state, which
the prefill cache takes.
"""
from __future__ import annotations

from typing import Tuple

import torch


def selective_scan_ref(
    x: torch.Tensor,         # (B, T, dI)  conv'd, silu'd inputs
    dt: torch.Tensor,        # (B, T, dI)  softplus'd step sizes
    A: torch.Tensor,         # (dI, N)     negative (A = -exp(A_log))
    Bc: torch.Tensor,        # (B, T, N)
    Cc: torch.Tensor,        # (B, T, N)
    D: torch.Tensor,         # (dI,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, dI) f32, final state (B, dI, N) f32), from a
    zero state, all arithmetic in f32."""
    B, T, dI = x.shape
    N = A.shape[1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bc, Cc))
    A, D = A.float(), D.float()
    h = torch.zeros((B, dI, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * A)                   # (B, dI, N)
        h = dA * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1) + D * xf[:, t])
    return torch.stack(ys, dim=1), h
