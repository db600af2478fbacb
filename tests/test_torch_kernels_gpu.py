"""Card-only: the CUDA kernels (flash attention, selective scan) against
their plain versions.

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
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

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


# the selective scan: y in x's dtype against the plain version's f32 y
# within the JAX package's bounds (f32 1e-4, bf16 5e-2) beyond the
# rounding of y to its dtype (2^-8 of |y| in bf16, which |y| of 16 and
# more exceeds), the final state within 1e-4 in every case (f32 on both
# sides)
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SCAN_ROUNDING = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}
SCAN_CASES = [
    (torch.bfloat16, torch.float32, 2, 256, 512, 16),
    (torch.bfloat16, torch.float32, 1, 200, 300, 16),   # ragged T and dI
    (torch.float32, torch.float32, 2, 128, 256, 8),
    (torch.bfloat16, torch.bfloat16, 2, 64, 128, 4),
]


def _scan_inputs(x_dtype, p_dtype, B, T, dI, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(T + dI)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rn(B, T, dI).to(x_dtype)
    dt = torch.nn.functional.softplus(rn(B, T, dI) - 2).to(p_dtype)
    A = -torch.exp(rn(dI, N) * 0.5)
    return x, dt, A, rn(B, T, N).to(p_dtype), rn(B, T, N).to(p_dtype), rn(dI)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,p_dtype,B,T,dI,N", SCAN_CASES)
def test_cuda_scan_matches_plain_version(x_dtype, p_dtype, B, T, dI, N):
    args = _scan_inputs(x_dtype, p_dtype, B, T, dI, N)
    before = selective_scan.launches
    y, h = selective_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    y_ref, h_ref = selective_scan_ref(*args)
    assert y.dtype == x_dtype and y.shape == y_ref.shape
    err = (y.float() - y_ref).abs() - SCAN_ROUNDING[x_dtype] * y_ref.abs()
    assert float(err.max()) < SCAN_TOL[x_dtype]
    assert float((h - h_ref).abs().max()) < 1e-4
