"""Bind the CUDA flash-attention kernels: the forward
(``csrc/flash_fwd.cu``) and the two backward kernels, dq and dk/dv
(``csrc/flash_bwd.cu``).

The libraries are built at first use by :mod:`repro_torch.kernels.build`
(``flash_fwd`` and ``flash_bwd``) and bound here with ``ctypes``. Nothing
is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 9
                                  + [i32, i32, f32, i32, ptr])
        lib.flash_fwd.restype = i32
    else:
        lib.flash_bwd_dq.argtypes = ([ptr] * 7 + [i32] * 6 + [i64] * 12
                                     + [i32, i32, f32, i32, ptr])
        lib.flash_bwd_dq.restype = i32
        lib.flash_bwd_dkv.argtypes = ([ptr] * 8 + [i32] * 6 + [i64] * 12
                                      + [i32, i32, f32, i32, ptr])
        lib.flash_bwd_dkv.restype = i32
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fn: str,
           *more: torch.Tensor) -> None:
    """Device, dtype, shape and stride checks shared by the three wrappers;
    ``more`` are further (B,T,H,D) tensors of q's dtype (do)."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v, *more)):
        raise ValueError(f"{fn} takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in (k, v, *more)):
        raise ValueError(f"{fn} takes float32 or bfloat16 inputs of one "
                         f"dtype, got {[x.dtype for x in (q, k, v, *more)]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if (k.shape != (B, S, K, D) or v.shape != k.shape or H % K
            or any(x.shape != q.shape for x in more)):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if any(x.stride(-1) != 1 for x in (q, k, v, *more)):
        raise ValueError(f"{fn} needs unit stride over head_dim")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors q (B,T,H,D), k and v
    (B,S,K,D).

    Returns (out (B,T,H,D) in q's dtype, lse (B,H,T) f32). Launches on the
    current stream and does not synchronize.
    """
    _check(q, k, v, "flash_fwd")
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _library("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, T, S, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), window or 0, scale, _DTYPES[q.dtype],
            build.stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {rc}")
    return out, lse


def _check_rows(lse: torch.Tensor, delta: torch.Tensor, q: torch.Tensor
                ) -> None:
    B, T, H, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (B, H, T) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (B,H,T) float32 "
                             f"tensor on q's device, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = True, window: Optional[int] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dq kernel: q, do (B,T,H,D), k, v (B,S,K,D), lse and
    delta = rowsum(do * out) (B,H,T) f32. Returns dq (B,T,H,D) in q's
    dtype. Launches on the current stream and does not synchronize."""
    _check(q, k, v, "flash_bwd_dq", do)
    _check_rows(lse, delta, q)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, T, S, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], int(causal), window or 0, scale,
            _DTYPES[q.dtype], build.stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: cudaError_t {rc}")
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel on the inputs of :func:`flash_bwd_dq`.
    Returns (dk, dv) (B,S,K,D) in k's dtype, each the sum over the H/K
    query heads of its kv head. Launches on the current stream and does
    not synchronize."""
    _check(q, k, v, "flash_bwd_dkv", do)
    _check_rows(lse, delta, q)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dk = torch.empty((B, S, K, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, K, D), dtype=k.dtype, device=q.device)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, S, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], int(causal), window or 0, scale,
            _DTYPES[q.dtype], build.stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: cudaError_t {rc}")
    return dk, dv
