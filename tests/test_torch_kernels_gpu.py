"""Card-only: the CUDA flash-attention kernel against its plain version.

Marked ``gpu``; each test skips inside its body on a host without a card.
Run on the card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_kernels_gpu.py``. Output bounds are the JAX package's
(f32 2e-5, bf16 2e-2); lse is held to 1e-3, since both sides compute it in
f32 from the same values, summing in different orders over up to 256 keys.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,causal,window,T", [
    ("bfloat16", 128, True, None, 256),
    ("bfloat16", 128, True, None, 200),
    ("bfloat16", 64, True, 48, 256),
    ("bfloat16", 128, False, None, 160),
    ("float32", 64, True, None, 256),
    ("float32", 32, True, 100, 130),
])
def test_cuda_kernel_matches_plain_version(dtype, D, causal, window, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, K = 2, 8, 2
    gen = torch.Generator(device="cuda").manual_seed(T * D)
    dt = getattr(torch, dtype)
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dt)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert float((out.float() - ref_out.float()).abs().max()) < TOL[dtype]
    assert float((lse - ref_lse).abs().max()) < 1e-3
