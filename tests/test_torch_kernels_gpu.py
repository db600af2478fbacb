"""Card-only: the CUDA flash-attention kernels against their plain versions.

Marked ``gpu``; each test skips inside its body on a host without a card.
Run on the card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_kernels_gpu.py``. Forward output bounds are the JAX
package's (f32 2e-5, bf16 2e-2); lse is held to 1e-3, since both sides
compute it in f32 from the same values, summing in different orders over up
to 256 keys. Gradients are held to max|err| / max|ref| below 1e-4 in f32
(``tests/test_kernels_flash.py``) and 2e-2 in bf16, whose outputs round to
8 bits of mantissa.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CASES = [
    ("bfloat16", 128, True, None, 256),
    ("bfloat16", 128, True, None, 200),
    ("bfloat16", 64, True, 48, 256),
    ("bfloat16", 128, False, None, 160),
    ("float32", 64, True, None, 256),
    ("float32", 32, True, 100, 130),
]


def _inputs(dtype, D, T, B=2, H=8, K=2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(T * D)
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((B, T, H, D), (B, T, K, D), (B, T, K, D),
                          (B, T, H, D))]


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,causal,window,T", CASES)
def test_cuda_kernel_matches_plain_version(dtype, D, causal, window, T):
    q, k, v, _ = _inputs(dtype, D, T)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert float((out.float() - ref_out.float()).abs().max()) < TOL[dtype]
    assert float((lse - ref_lse).abs().max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,causal,window,T", CASES)
def test_cuda_backward_kernels_match_plain_version(dtype, D, causal, window,
                                                   T):
    q, k, v, do = _inputs(dtype, D, T)
    out, lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    dq0, dkv0 = flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert flash_attention.bwd_dq_launches == dq0 + 1
    assert flash_attention.bwd_dkv_launches == dkv0 + 1
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) < GRAD_TOL[dtype], (name, _rel(a, b))


@pytest.mark.gpu
def test_autograd_function_on_the_card_matches_cpu():
    q, k, v, do = _inputs("float32", 64, 96)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out, _ = FlashAttention.apply(*leaves, True, None)
        grads.append(torch.autograd.grad(out, leaves, do.to(dev)))
    for a, b in zip(*grads):
        assert _rel(a.cpu(), b) < 1e-4
