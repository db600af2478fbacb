"""Bind the CUDA selective-scan kernels: the forward
(``csrc/selective_scan.cu``) and its backward
(``csrc/selective_scan_bwd.cu``).

The libraries are built at first use by :mod:`repro_torch.kernels.build`
(``selective_scan``, ``selective_scan_bwd``) and bound here with
``ctypes``. Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import build

STATE_SIZES = (4, 8, 16)
TILE = 32          # time steps a staged tile
SAVE_EVERY = 16    # time steps between the states a training forward saves
CHANNELS = 64      # channels a block: the backward's dB, dC partials
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("selective_scan")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan.argtypes = [ptr] * 9 + [i32] * 4 + [i64] * 8 + [
        i32, i32, ptr]
    lib.selective_scan.restype = i32
    lib.selective_scan_info.argtypes = [i32] * 3 + [ptr] * 2
    lib.selective_scan_info.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = build.load("selective_scan_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan_bwd.argtypes = [ptr] * 14 + [i32] * 4 + [i64] * 8 + [
        i32, i32, ptr]
    lib.selective_scan_bwd.restype = i32
    lib.selective_scan_bwd_info.argtypes = [i32] * 3 + [ptr] * 2
    lib.selective_scan_bwd_info.restype = i32
    return lib


def n_chunks(T: int) -> int:
    """Runs of ``SAVE_EVERY`` steps in T: the saved states' second
    axis."""
    return -(-T // SAVE_EVERY)


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
                   return_state: bool = False, save_chunks: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """Launch the kernel on CUDA tensors x, dt (B,T,dI), A (dI,N) f32,
    Bc, Cc (B,T,N), D (dI,) f32.

    Returns (y (B,T,dI) in x's dtype, final state (B,dI,N) f32 or None
    unless ``return_state``, the state after every ``SAVE_EVERY`` steps
    and at T (B, n_chunks(T), dI, N) f32 or None unless
    ``save_chunks``: what :func:`selective_scan_bwd` takes). Launches on
    the current stream and does not synchronize.
    """
    _check(x, dt, A, Bc, Cc, D)
    B, T, dI = x.shape
    N = A.shape[1]
    y = torch.empty((B, T, dI), dtype=x.dtype, device=x.device)
    h = (torch.empty((B, dI, N), dtype=torch.float32, device=x.device)
         if return_state else None)
    chunks = (torch.empty((B, n_chunks(T), dI, N), dtype=torch.float32,
                          device=x.device) if save_chunks else None)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.selective_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), y.data_ptr(),
            h.data_ptr() if h is not None else None,
            chunks.data_ptr() if chunks is not None else None, B, T, dI, N,
            *x.stride()[:2], *dt.stride()[:2], *Bc.stride()[:2],
            *Cc.stride()[:2], _DTYPES[x.dtype], _DTYPES[dt.dtype],
            build.stream(x.device))
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: cudaError_t {rc}")
    return y, h, chunks


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                       dy: torch.Tensor, chunks: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel on the forward's CUDA inputs, ``dy``
    (B,T,dI), the gradient of y, and ``chunks``, the states the forward
    saved (``save_chunks``).

    Returns (dx, ddt, dA, dBc, dCc, dD), each in its input's dtype and
    shape. dA, dD, dBc and dCc are the kernel's f32 partial sums (over
    batch rows, and over blocks of ``CHANNELS`` channels) summed over their
    leading axis in a fixed order, so that every launch gives the same
    bits. Launches on the current stream and does not synchronize.
    """
    _check(x, dt, A, Bc, Cc, D)
    B, T, dI = x.shape
    N = A.shape[1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    if (chunks.shape != (B, n_chunks(T), dI, N)
            or chunks.dtype != torch.float32 or chunks.device != x.device
            or not chunks.is_contiguous()):
        raise ValueError(f"chunks must be contiguous float32 "
                         f"{(B, n_chunks(T), dI, N)} on {x.device}, got "
                         f"{tuple(chunks.shape)} {chunks.dtype}")
    dy = dy.contiguous()
    dev = x.device
    dx = torch.empty((B, T, dI), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, T, dI), dtype=dt.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dA_part = torch.empty((B, dI, N), **f32)
    dD_part = torch.empty((B, dI), **f32)
    blocks = -(-dI // CHANNELS)
    dB_part = torch.empty((blocks, B, T, N), **f32)
    dC_part = torch.empty((blocks, B, T, N), **f32)
    lib = _bwd_library()
    with torch.cuda.device(dev):
        rc = lib.selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), dy.data_ptr(), chunks.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(),
            dD_part.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
            B, T, dI, N, *x.stride()[:2], *dt.stride()[:2],
            *Bc.stride()[:2], *Cc.stride()[:2], _DTYPES[x.dtype],
            _DTYPES[dt.dtype], build.stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"selective_scan_bwd launch failed: cudaError_t {rc}")
    return (dx, ddt, dA_part.sum(0), dB_part.sum(0).to(Bc.dtype),
            dC_part.sum(0).to(Cc.dtype), dD_part.sum(0))


def selective_scan_info(N: int, x_dtype: torch.dtype, p_dtype: torch.dtype,
                        backward: bool = False) -> Tuple[int, int]:
    """(dynamic shared memory in bytes, blocks that fit an SM) of the
    forward kernel, or with ``backward`` of the backward kernel, for state
    size ``N``, x in ``x_dtype`` and dt, Bc, Cc in ``p_dtype``, from the
    CUDA runtime on the current card."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    query = (_bwd_library().selective_scan_bwd_info if backward
             else _library().selective_scan_info)
    rc = query(N, _DTYPES[x_dtype], _DTYPES[p_dtype], ctypes.byref(smem),
               ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"selective_scan_info failed: cudaError_t {rc}")
    return smem.value, blocks.value
