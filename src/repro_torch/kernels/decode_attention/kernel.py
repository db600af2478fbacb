"""Bind the CUDA decode-attention kernel (``csrc/decode_attn.cu``): one
query position against the KV cache, its slots split over the blocks of
a thread block cluster that combine their partial softmaxes through
distributed shared memory.

bfloat16 caches run on the tensor cores (``mma.sync``, fed by 16-byte
``cp.async`` copies); float32 caches on a scalar f32 kernel.
:func:`n_splits` picks how many blocks share a (batch row, kv head) from
the shapes alone. The library is built at first use by
:mod:`repro_torch.kernels.build` (``decode_attn``) and bound here with
``ctypes``. Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from .. import build

HEAD_DIMS = (16, 64, 128, 256)
MAX_GROUP = 8          # query heads a kv head: the mma's padded rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 2      # the bf16 kernel's blocks an SM at D <= 128
MIN_SPLIT_SLOTS = 64   # allocated slots a split, at least: a 16-slot tile
                       # for each of a block's 4 warps
MAX_SPLITS = 8         # blocks a cluster: the portable most


def n_splits(B: int, K: int, S: int, sms: int) -> int:
    """Blocks a (batch row, kv head), one cluster: as many as fill the
    card's SMs ``BLOCKS_PER_SM`` deep in one wave (B 32, K 4: 2), at most
    ``MAX_SPLITS`` (B 4, K 4: 8), and no more than leave
    ``MIN_SPLIT_SLOTS`` of the S allocated slots a split. Each block takes
    an even share, in whole 16-slot tiles, of the slots the query reads."""
    return max(1, min((BLOCKS_PER_SM * sms) // (B * K),
                      S // MIN_SPLIT_SLOTS, MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of the CUDA card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("decode_attn")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attn.argtypes = [ptr] * 6 + [i32] * 7 + [i64] * 6 + [i32, ptr]
    lib.decode_attn.restype = i32
    return lib


def check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          pos_k: torch.Tensor, pos_q: torch.Tensor,
          window: Optional[int]) -> None:
    """Raise ValueError for what the kernel does not take: a dtype other
    than float32 or bfloat16 (q and both caches alike), D outside
    :data:`HEAD_DIMS`, more than :data:`MAX_GROUP` query heads a kv head,
    positions that are not int32, or caches whose head dimension is not
    unit-stride or whose base and strides are not multiples of 16 bytes
    (and ``pos_k``'s base too: the kernel copies positions 4 at a time)."""
    B, _, K, G, D = q.shape
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode attention takes float32 or bfloat16 q and "
                         f"caches of one dtype, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"{G} query heads a kv head: the kernel takes 1 to "
                         f"{MAX_GROUP}")
    if not (B <= 65535 and K <= 65535):
        raise ValueError(f"B {B} and K {K} must be at most 65535")
    if pos_k.dtype != torch.int32 or pos_q.dtype != torch.int32:
        raise ValueError(f"positions must be int32, got pos_k {pos_k.dtype}, "
                         f"pos_q {pos_q.dtype}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.stride(3) != 1 or _base(x) % 16 or any(
                s * x.element_size() % 16 for s in x.stride()[:3]):
            raise ValueError(f"{name} needs unit stride over D and a base "
                             f"and strides of whole 16 bytes, got strides "
                             f"{tuple(x.stride())}")
    if pos_k.stride(0) != 1 or _base(pos_k) % 16:
        raise ValueError("pos_k needs unit stride and a base of whole 16 "
                         "bytes")


def _base(x: torch.Tensor) -> int:
    """The address of ``x``; of a fake tensor (the dry run's), which has
    none, its offset into its storage."""
    return (x.storage_offset() * x.element_size() if is_fake(x)
            else x.data_ptr())


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos_k: torch.Tensor, pos_q: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q (B, 1, K, G, D), k_cache,
    v_cache (B, S, K, D), pos_k (S,) and pos_q (0-d) int32; returns out
    (B, 1, K, G, D) in the cache's dtype, the one tensor it allocates.
    Launches on the current stream, does not synchronize and reads
    nothing back to the host."""
    check(q, k_cache, v_cache, pos_k, pos_q, window)
    B, _, K, G, D = q.shape
    S = k_cache.shape[1]
    q = q.contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.decode_attn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos_k.data_ptr(), pos_q.data_ptr(), out.data_ptr(), B, S, K, G, D,
            n_splits(B, K, S, sm_count(q.device)), window or 0,
            *k_cache.stride()[:3], *v_cache.stride()[:3], _DTYPES[q.dtype],
            build.stream(q.device))
    if rc != 0:
        raise RuntimeError(f"decode_attn launch failed: cudaError_t {rc}")
    return out

