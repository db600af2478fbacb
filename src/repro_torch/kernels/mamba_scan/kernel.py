"""Bind the CUDA selective-scan kernel (``csrc/selective_scan.cu``).

The library is built at first use by :mod:`repro_torch.kernels.build`
(``selective_scan``) and bound here with ``ctypes``. Nothing is built or
loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import build

STATE_SIZES = (4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("selective_scan")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 8 + [
        i32, i32, ptr]
    lib.selective_scan.restype = i32
    return lib


def _check(x, dt, A, Bc, Cc, D) -> None:
    """Device, dtype, shape and stride checks of the kernel's inputs."""
    B, T, dI = x.shape
    N = A.shape[-1]
    if not all(t.is_cuda and t.device == x.device for t in (x, dt, A, Bc, Cc, D)):
        raise ValueError("selective_scan takes CUDA tensors on one device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if dt.dtype not in (torch.float32, x.dtype) or any(
            t.dtype != dt.dtype for t in (Bc, Cc)):
        raise ValueError("dt, Bc and Cc take one dtype, float32 or x's: got "
                         f"{dt.dtype}, {Bc.dtype}, {Cc.dtype} for x {x.dtype}")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"A and D must be float32, got {A.dtype}, {D.dtype}")
    if N not in STATE_SIZES:
        raise ValueError(f"d_state {N} not in {STATE_SIZES}")
    if (dt.shape != x.shape or A.shape != (dI, N) or D.shape != (dI,)
            or Bc.shape != (B, T, N) or Cc.shape != Bc.shape):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} Bc {tuple(Bc.shape)} "
                         f"Cc {tuple(Cc.shape)} D {tuple(D.shape)}")
    if not (1 <= B <= 65535 and T >= 1 and dI >= 1):
        raise ValueError(f"selective_scan needs 1 <= B <= 65535, T, dI >= 1: "
                         f"got {tuple(x.shape)}")
    if any(t.stride(-1) != 1 for t in (x, dt, Bc, Cc)):
        raise ValueError("selective_scan needs unit stride over dI and N")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("A and D must be contiguous")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                   return_state: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel on CUDA tensors x, dt (B,T,dI), A (dI,N) f32,
    Bc, Cc (B,T,N), D (dI,) f32.

    Returns (y (B,T,dI) in x's dtype, final state (B,dI,N) f32 or None
    unless ``return_state``). Launches on the current stream and does not
    synchronize.
    """
    _check(x, dt, A, Bc, Cc, D)
    B, T, dI = x.shape
    N = A.shape[1]
    y = torch.empty((B, T, dI), dtype=x.dtype, device=x.device)
    h = (torch.empty((B, dI, N), dtype=torch.float32, device=x.device)
         if return_state else None)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.selective_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), y.data_ptr(),
            h.data_ptr() if h is not None else None, B, T, dI, N,
            *x.stride()[:2], *dt.stride()[:2], *Bc.stride()[:2],
            *Cc.stride()[:2], _DTYPES[x.dtype], _DTYPES[dt.dtype],
            build.stream(x.device))
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: cudaError_t {rc}")
    return y, h
