"""Bind the CUDA flash-attention kernels: the forward
(``csrc/flash_fwd.cu``) and the two backward kernels, dq and dk/dv
(``csrc/flash_bwd.cu``).

The dtype picks each kernel's variant (:func:`variant`): bfloat16 runs all
three on the tensor cores (``wgmma``, fed by ``cp.async`` copies, which need
16-byte aligned pointers and strides: :func:`check_aligned` raises before the
launch otherwise); float32 runs them as scalar f32 FMA. Each C entry reports
the kernel it launched, and :data:`launches_by_variant` counts every launch
under "<kernel>/<variant>" from that report.

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

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the variant each kernel launches, by input dtype
VARIANTS = {
    "fwd": {torch.float32: "scalar", torch.bfloat16: "wgmma"},
    "dq": {torch.float32: "scalar", torch.bfloat16: "wgmma"},
    "dkv": {torch.float32: "scalar", torch.bfloat16: "wgmma"},
}


# launches by "<kernel>/<variant>" (fwd, dq, dkv; wgmma or scalar), as the C
# entries report the kernel they ran; ops.flash_attention shares this dict
launches_by_variant = {f"{name}/{v}": 0 for name, by_dtype in VARIANTS.items()
                       for v in sorted(set(by_dtype.values()))}
# what a C entry writes to its last argument, *launched
_LAUNCHED = ("scalar", "wgmma")


def variant(name: str, dtype: torch.dtype) -> str:
    """The variant of kernel ``name`` (fwd, dq, dkv) that inputs of
    ``dtype`` launch: "wgmma" (tensor cores) or "scalar" (f32 FMA)."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {dtype}")
    return VARIANTS[name][dtype]


def check_aligned(fn: str, *tensors: torch.Tensor) -> None:
    """Raise ValueError unless every tensor's base address and every stride
    of a dimension longer than 1 (the head dimension's is 1) are multiples
    of 16 bytes, as the 16-byte ``cp.async`` copies of the wgmma variants
    need. Nothing is copied to make them so."""
    for x in tensors:
        if x.data_ptr() % 16 or any(
                n > 1 and st * x.element_size() % 16
                for n, st in zip(x.shape[:-1], x.stride()[:-1])):
            raise ValueError(
                f"{fn}: the bf16 tensor-core kernel needs 16-byte aligned "
                f"pointers and strides, got shape {tuple(x.shape)} stride "
                f"{x.stride()} at address {x.data_ptr():#x}")


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 9
                                  + [i32, i32, f32, i32, ptr, ptr])
        lib.flash_fwd.restype = i32
        lib.wgmma_probe.argtypes = [ptr] * 5 + [i32, ptr]
        lib.wgmma_probe.restype = i32
        lib.flash_fwd_wgmma_info.argtypes = [i32, ptr, ptr]
        lib.flash_fwd_wgmma_info.restype = i32
    else:
        lib.flash_bwd_dq.argtypes = ([ptr] * 7 + [i32] * 6 + [i64] * 12
                                     + [i32, i32, f32, i32, ptr, ptr])
        lib.flash_bwd_dq.restype = i32
        lib.flash_bwd_dkv.argtypes = ([ptr] * 8 + [i32] * 6 + [i64] * 12
                                      + [i32, i32, f32, i32, ptr, ptr])
        lib.flash_bwd_dkv.restype = i32
        for info in ("flash_bwd_dq_wgmma_info", "flash_bwd_dkv_wgmma_info"):
            getattr(lib, info).argtypes = [i32, ptr, ptr]
            getattr(lib, info).restype = i32
    return lib


def _launch(name: str, entry, *args) -> None:
    """Call C entry ``entry`` of kernel ``name`` (fwd, dq, dkv) with
    ``args``; raise on a failed launch, else count it under the variant
    that the entry reports it launched."""
    launched = ctypes.c_int(-1)
    rc = entry(*args, ctypes.byref(launched))
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: cudaError_t {rc}")
    launches_by_variant[f"{name}/{_LAUNCHED[launched.value]}"] += 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fn: str,
           kind: str, *more: torch.Tensor) -> None:
    """Device, dtype, shape, stride and alignment checks shared by the three
    wrappers of kernels ``kind`` (fwd, dq, dkv); ``more`` are further
    (B,T,H,D) tensors of q's dtype (do)."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
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
    if variant(kind, q.dtype) == "wgmma":
        check_aligned(fn, q, k, v, *more)
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v, *more)):
        raise ValueError(f"{fn} takes CUDA tensors on one device")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors q (B,T,H,D), k and v
    (B,S,K,D).

    Returns (out (B,T,H,D) in q's dtype, lse (B,H,T) f32). Launches on the
    current stream and does not synchronize.
    """
    _check(q, k, v, "flash_fwd", "fwd")
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _library("flash_fwd")
    with torch.cuda.device(q.device):
        _launch("fwd", lib.flash_fwd,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, T, S, H, K, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(causal), window or 0, scale, _DTYPES[q.dtype],
                build.stream(q.device))
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
    _check(q, k, v, "flash_bwd_dq", "dq", do)
    _check_rows(lse, delta, q)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        _launch("dq", lib.flash_bwd_dq,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                B, T, S, H, K, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], int(causal), window or 0, scale,
                _DTYPES[q.dtype], build.stream(q.device))
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
    _check(q, k, v, "flash_bwd_dkv", "dkv", do)
    _check_rows(lse, delta, q)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dk = torch.empty((B, S, K, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, K, D), dtype=k.dtype, device=q.device)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        _launch("dkv", lib.flash_bwd_dkv,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, T, S, H, K, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], int(causal), window or 0, scale,
                _DTYPES[q.dtype], build.stream(q.device))
    return dk, dv


def wgmma_probe(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Test entry of ``flash_fwd.cu``: one warpgroup's two tensor-core
    products, formed as the bf16 forward forms S = Q K^T and O = P V. a, b,
    v (64, D) bf16 contiguous CUDA tensors, D in HEAD_DIMS. Returns (c1 =
    a b^T (64, 64), c2 = bf16(c1) v (64, D)), both f32."""
    D = a.shape[1]
    if (D not in HEAD_DIMS or any(x.shape != (64, D) or x.dtype != torch.bfloat16
                                  or not x.is_cuda or not x.is_contiguous()
                                  for x in (a, b, v))):
        raise ValueError("wgmma_probe takes contiguous (64, D) bf16 CUDA "
                         f"tensors, D in {HEAD_DIMS}")
    c1 = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    c2 = torch.empty((64, D), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _library("flash_fwd").wgmma_probe(
            a.data_ptr(), b.data_ptr(), v.data_ptr(), c1.data_ptr(),
            c2.data_ptr(), D, build.stream(a.device))
    if rc != 0:
        raise RuntimeError(f"wgmma_probe launch failed: cudaError_t {rc}")
    return c1, c2


def wgmma_info(name: str, head_dim: int) -> Tuple[int, int]:
    """(dynamic shared memory in bytes, blocks that fit an SM) of the bf16
    tensor-core kernel ``name`` (fwd, dq, dkv) at ``head_dim``, from the
    CUDA runtime on the current card."""
    fn = {"fwd": ("flash_fwd", "flash_fwd_wgmma_info"),
          "dq": ("flash_bwd", "flash_bwd_dq_wgmma_info"),
          "dkv": ("flash_bwd", "flash_bwd_dkv_wgmma_info")}[name]
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = getattr(_library(fn[0]), fn[1])(head_dim, ctypes.byref(smem),
                                         ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{fn[1]} failed: cudaError_t {rc}")
    return smem.value, blocks.value
