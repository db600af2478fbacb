"""Build and bind the CUDA flash-attention forward kernel (``csrc/flash_fwd.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/repro_torch/`` at the
root of the checkout, named by the source's hash, and loaded with
``ctypes``. Nothing is built or loaded when this module is imported. A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_CUDA_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or _CUDA_NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA flash-attention kernel cannot be built")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libflash_fwd_{digest}.so"


def build() -> Path:
    """Compile the kernel unless this source's library exists; return its
    path. The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside it as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 9
                              + [i32, i32, ctypes.c_float, i32, ptr])
    lib.flash_fwd.restype = i32
    return lib


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors q (B,T,H,D), k and v (B,S,K,D).

    Returns (out (B,T,H,D) in q's dtype, lse (B,H,T) f32). Launches on the
    current stream and does not synchronize.
    """
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_fwd takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd takes float32 or bfloat16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if k.shape != (B, S, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_fwd needs unit stride over head_dim")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, T, S, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), window or 0, scale, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {rc}")
    return out, lse
