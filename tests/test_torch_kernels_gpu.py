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

bf16 runs the forward, dq and dk/dv on the tensor-core (wgmma) kernels, f32
on the scalar ones, as ``flash_attention.launches_by_variant`` shows; the bf16
cases below cover head dims 32, 64 and 128, lengths 1, 17, 200 and 1000
(shorter than a tile and not multiples of it), a window of 48 that starts
inside a 64-key tile, non-causal attention with S != T at the kernel level,
and G = H/K of 1 and 8 query heads a kv head. One 64 x N x 16 wgmma product
is held to torch.matmul on its own (``kernel.wgmma_probe``).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel
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


def _variants():
    return dict(flash_attention.launches_by_variant)


def _delta(before):
    return {k: n - before[k] for k, n in _variants().items() if n != before[k]}


# bf16 tensor-core cases: (D, T, causal, window, G), B = 2, K = 2, H = K G
BF16_CASES = [
    (128, 1, True, None, 8),
    (128, 17, True, None, 1),
    (64, 200, True, None, 8),
    (32, 1000, True, None, 4),
    (128, 1000, True, None, 8),
    (128, 200, True, 48, 8),
    (64, 1000, True, 48, 1),
    (32, 17, False, None, 8),
    (64, 200, False, 48, 2),
]


def _bf16_inputs(D, T, G, S=None, B=2, K=2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1000 * D + T + G)
    S = T if S is None else S
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    return (rn(B, T, K * G, D), rn(B, S, K, D), rn(B, S, K, D),
            rn(B, T, K * G, D))


@pytest.mark.gpu
@pytest.mark.parametrize("D,T,causal,window,G", BF16_CASES)
def test_bf16_forward_runs_on_the_tensor_cores(D, T, causal, window, G):
    q, k, v, _ = _bf16_inputs(D, T, G)
    before = _variants()
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _delta(before) == {"fwd/wgmma": 1}
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert float((out.float() - ref_out.float()).abs().max()) < TOL["bfloat16"]
    assert float((lse - ref_lse).abs().max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("D,T,causal,window,G",
                         [c for c in BF16_CASES if c[1] > 1])
def test_bf16_dkv_runs_on_the_tensor_cores(D, T, causal, window, G):
    q, k, v, do = _bf16_inputs(D, T, G)
    out, lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    before = _variants()
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert _delta(before) == {"dq/wgmma": 1, "dkv/wgmma": 1}
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) < GRAD_TOL["bfloat16"], (name, _rel(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("D,T,S,window", [
    (128, 1, 33, None), (64, 17, 300, None), (128, 160, 100, None),
    (32, 200, 1000, 48),
])
def test_bf16_kernels_take_s_other_than_t(D, T, S, window):
    """Non-causal, keys and queries of different lengths, straight through
    the kernel bindings."""
    q, k, v, do = _bf16_inputs(D, T, 4, S=S)
    before = _variants()
    out, lse = kernel.flash_fwd(q, k, v, causal=False, window=window)
    torch.cuda.synchronize()
    # the count comes from the C entry's report of the kernel it ran
    assert _delta(before) == {"fwd/wgmma": 1}
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal=False,
                                           window=window)
    assert float((out.float() - ref_out.float()).abs().max()) < TOL["bfloat16"]
    # a row whose window holds no key has lse -inf on both sides
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert float((lse[fin] - ref_lse[fin]).abs().max()) < 1e-3
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2).contiguous()
    before = _variants()
    dk, dv = kernel.flash_bwd_dkv(q, k, v, do, ref_lse.contiguous(), delta,
                                  causal=False, window=window)
    torch.cuda.synchronize()
    assert _delta(before) == {"dkv/wgmma": 1}
    _, rdk, rdv = flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, do,
                                          causal=False, window=window)
    assert _rel(dk, rdk) < GRAD_TOL["bfloat16"]
    assert _rel(dv, rdv) < GRAD_TOL["bfloat16"]


@pytest.mark.gpu
def test_f32_runs_on_the_scalar_kernels():
    q, k, v, do = _inputs("float32", 64, 130)
    before = _variants()
    out, lse = flash_attention(q, k, v)
    flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert _delta(before) == {"fwd/scalar": 1, "dq/scalar": 1,
                                     "dkv/scalar": 1}


@pytest.mark.gpu
def test_misaligned_bf16_input_raises_before_launch():
    q, k, v, _ = _bf16_inputs(64, 40, 2)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    before = _variants()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, k, v)
    assert _variants() == before


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
def test_misaligned_bf16_dq_raises_before_launch(which):
    q, k, v, do = _bf16_inputs(64, 40, 2)
    t = {"q": q, "k": k, "v": v, "do": do}
    flat = torch.empty(t[which].numel() + 1, dtype=q.dtype, device=q.device)
    t[which] = flat[1:].view(t[which].shape)
    rows = torch.zeros(2, 4, 40, device=q.device)
    before = _variants()
    with pytest.raises(ValueError, match="16-byte"):
        kernel.flash_bwd_dq(t["q"], t["k"], t["v"], t["do"], rows, rows)
    assert _variants() == before


@pytest.mark.gpu
@pytest.mark.parametrize("D,T,causal,window,G", [
    (128, 1000, True, None, 8), (64, 200, False, 48, 2)])
def test_bf16_dq_is_bit_identical_from_launch_to_launch(D, T, causal, window,
                                                         G):
    """Each block owns its dq tile and sums in a fixed order: no atomics."""
    q, k, v, do = _bf16_inputs(D, T, G)
    out, lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    first, second = (kernel.flash_bwd_dq(q, k, v, do, lse, delta,
                                         causal=causal, window=window)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 64, 128])
def test_one_wgmma_product_matches_matmul(D):
    """c1 = a b^T through wgmma m64n64k16 with both operands K-major in
    swizzled shared memory; c2 = bf16(c1) v with c1's accumulator as the
    register A operand and v MN-major: the two products of the forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(D)
    a, b, v = (torch.randn(64, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    c1, c2 = kernel.wgmma_probe(a, b, v)
    torch.cuda.synchronize()
    want1 = torch.matmul(a.float(), b.float().T)
    want2 = torch.matmul(c1.to(torch.bfloat16).float(), v.float())
    # f32 sums of exact bf16 products in another order
    assert float((c1 - want1).abs().max()) < 1e-4 * float(want1.abs().max())
    assert float((c2 - want2).abs().max()) < 1e-4 * float(want2.abs().max())


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
    # one and two lanes a channel, ragged T and dI
    (torch.bfloat16, torch.float32, 2, 77, 200, 4),
    (torch.bfloat16, torch.bfloat16, 3, 100, 136, 8),
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


@pytest.mark.gpu
@pytest.mark.parametrize("R,N", [(256, 16), (3, 16), (5, 8)])
def test_cuda_scan_takes_strided_slices(R, N):
    """dt, Bc and Cc sliced from one projection (B, T, dI + R + 2N) as the
    mamba mixer slices them: 16-byte copies where the slices are aligned,
    element by element where they are not."""
    x, _, A, _, _, D = _scan_inputs(torch.bfloat16, torch.float32, 2, 70,
                                    192, N)
    gen = torch.Generator(device="cuda").manual_seed(R)
    proj = torch.randn(2, 70, 192 + R + 2 * N, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(proj[..., :192] - 2)
    Bc, Cc = proj[..., 192 + R:192 + R + N], proj[..., 192 + R + N:]
    y, h = selective_scan(x, dt, A, Bc, Cc, D, return_state=True)
    torch.cuda.synchronize()
    y_ref, h_ref = selective_scan_ref(x, dt, A, Bc, Cc, D)
    err = (y.float() - y_ref).abs() - SCAN_ROUNDING[x.dtype] * y_ref.abs()
    assert float(err.max()) < SCAN_TOL[x.dtype]
    assert float((h - h_ref).abs().max()) < 1e-4
