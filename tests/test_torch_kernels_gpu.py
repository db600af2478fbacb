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
is held to torch.matmul on its own (``kernel.wgmma_probe``). Head dim 256
(gemma3) runs the forward, dq and dk/dv, with and without a window; a
train step of gemma3 (head dim 256), the MoE, the xLSTM and the jamba
smoke presets in f32 matches the CPU. A captured decode step gives the
eager step's tokens and logits on the smoke presets of the four served
families, and a traced captured call names the capture's four stretches
and changes no token or logit. The selective scan's backward kernel matches the plain backward
(autograd through the plain scan) per gradient, to the bound of the
gradient's dtype, and gives the same bits from launch to launch; the
training forward saves the plain scan's state every 16 steps. Decode
attention's kernel matches the plain version (f32 from the same inputs) at
the benchmark cells' shapes, every head dim and group size it takes, a
wrapped window ring and an all-valid cross cache, reads a global layer's
filled slots and none past them; a captured graph
replays it at any position bit for bit; shapes and dtypes it does not
take raise before a launch.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.mamba_scan.ops import SelectiveScan, selective_scan
from repro_torch.kernels.mamba_scan.ref import (selective_scan_bwd_ref,
                                                selective_scan_ref)

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


# ------------------------------------------------------------ head dim 16
#
# The smoke preset's head dim: bf16 on the tensor cores (32-byte swizzled
# tiles, m64n16k16 products), f32 on the scalar kernels with half a warp's
# lanes on the head dim. Bounds as above.

D16_CASES = [
    ("bfloat16", True, None, 256, 4, 4),     # the default commands' shape
    ("bfloat16", True, None, 200, 8, 2),
    ("bfloat16", True, 48, 1000, 8, 2),
    ("bfloat16", False, None, 17, 2, 2),
    ("float32", True, None, 200, 8, 2),
    ("float32", True, 8, 17, 4, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,causal,window,T,H,K", D16_CASES)
def test_head_dim_16_kernels_match_plain_versions(dtype, causal, window, T,
                                                  H, K):
    q, k, v, do = _inputs(dtype, 16, T, H=H, K=K)
    before = _variants()
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    v_name = "wgmma" if dtype == "bfloat16" else "scalar"
    assert _delta(before) == {f"fwd/{v_name}": 1, f"dq/{v_name}": 1,
                              f"dkv/{v_name}": 1}
    r_out, r_lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert float((out.float() - r_out.float()).abs().max()) < TOL[dtype]
    assert float((lse - r_lse).abs().max()) < 1e-3
    want = flash_attention_bwd_ref(q, k, v, r_out, r_lse, do, causal=causal,
                                   window=window)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _rel(got, ref) < GRAD_TOL[dtype]


@pytest.mark.gpu
def test_one_wgmma_product_matches_matmul_at_head_dim_16():
    test_one_wgmma_product_matches_matmul(16)


# ------------------------------------------------- the default commands
#
# serve.main and train.main with their default arguments (the smoke
# preset: bf16 compute, head dim 16) on the card, held to the same call
# with --device cpu. Weights are drawn alike on both devices
# (models.common.normal_). Prefill logits within 2e-2 of max|ref| (the
# kernels' bf16 bound); greedy tokens may differ only where bf16 rounding
# flips a near tie, so the first token is held only where the CPU's top-2
# margin exceeds twice the logits' error; losses within 1e-3 (f32 losses
# of bf16 compute, ~5.5).

@pytest.mark.gpu
@pytest.mark.parametrize("argv", [[], ["--arch", "jamba-v0.1-52b"]],
                         ids=["yi-6b", "jamba"])
def test_default_serve_command_on_the_card_matches_cpu(argv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch import serve

    before = _variants()
    tokens, stats = serve.main(argv)
    used = _delta(before)
    cpu_tokens, cpu_stats = serve.main(argv + ["--device", "cpu"])
    got, want = stats["prefill_logits"], cpu_stats["prefill_logits"]
    assert _rel(got, want) < 2e-2
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * float((got - want).abs().max())
    assert bool((tokens[:, :1].cpu() == cpu_tokens[:, :1])[clear].all())
    assert set(used) == {"fwd/wgmma"}


@pytest.mark.gpu
def test_default_train_command_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch import train

    losses, stats = train.main(["--steps", "4"])
    cpu_losses, _ = train.main(["--steps", "4", "--device", "cpu"])
    assert max(abs(a - b) for a, b in zip(losses, cpu_losses)) < 1e-3
    for step in stats["launches_by_variant"]:
        assert {k: n for k, n in step.items() if n} == {
            "fwd/wgmma": 2, "dq/wgmma": 1, "dkv/wgmma": 1}


# ------------------------------------------------------------ the halo app

@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["xla_auto", "explicit_serial",
                                     "explicit_overlap",
                                     "explicit_serial_oversub"])
def test_halo_app_on_the_card_matches_cpu(backend):
    """Output within 1e-5 relative (f32 stencil sums), the same checksum,
    and the same fabric counters but for sampled times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch import halo

    card, out_c = halo.run(backend, box=16, steps=3, runs=1, device="cuda")
    cpu, out_p = halo.run(backend, box=16, steps=3, runs=1, device="cpu")
    assert out_c.is_cuda
    assert _rel(out_c.cpu(), out_p) < 1e-5
    assert abs(card["checksum"] - cpu["checksum"]) < 1e-5 * cpu["checksum"]
    timeless = lambda c: {k: v["count"] if k.endswith("_ns") else v
                          for k, v in c.items()}
    assert timeless(card["counters"]) == timeless(cpu["counters"])


@pytest.mark.gpu
def test_progress_engine_issues_on_its_own_stream():
    """The engine's thread issues on a stream other than the caller's, so
    the exchange can overlap the caller's interior stencil; Request.wait
    orders the caller's stream after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.comm.progress import ProgressEngine

    eng = ProgressEngine("incoming")
    try:
        x = torch.arange(1 << 20, device="cuda", dtype=torch.float32)
        caller = torch.cuda.current_stream()
        req = eng.submit(lambda t: (torch.cuda.current_stream(), t * 2), x)
        stream, y = req.wait(timeout=30)
        assert stream == eng.stream and stream != caller
        assert torch.equal(y, x * 2)
    finally:
        eng.shutdown()


@pytest.mark.gpu
def test_profile_of_one_bf16_forward_shows_the_wgmma_kernel_once():
    from repro_torch.core import device_timeline

    q, k, v, _ = _inputs("bfloat16", 128, 256)
    flash_attention(q, k, v)                        # warm-up
    torch.cuda.synchronize()
    before = dict(flash_attention.launches_by_variant)
    (out, _), trace = device_timeline.profile(flash_attention, q, k, v)
    assert flash_attention.launches_by_variant["fwd/wgmma"] == (
        before["fwd/wgmma"] + 1)
    seen = device_timeline.launches_by_symbol(
        trace, ["flash_fwd_wgmma_kernel", "flash_fwd_f32_kernel"])
    assert seen == {"flash_fwd_wgmma_kernel": 1, "flash_fwd_f32_kernel": 0}
    rep = device_timeline.device_report(trace)
    assert 0 < rep["busy_ms"] <= rep["window_ms"]
    assert torch.isfinite(out.float()).all()


@pytest.mark.gpu
def test_profiled_overlap_halo_step_puts_its_collectives_on_the_engine():
    from repro_torch.launch import halo as halo_app

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    payload, _ = halo_app.run("explicit_overlap", box=16, steps=1, runs=1,
                              device="cuda", emit_device_timeline=True)
    dt = payload["device_timeline"]
    streams = dt["device"]["streams"]
    assert len(dt["engine_streams"]) == 1 and len(streams) > 1
    engine = dt["engine_streams"][0]
    assert streams[engine]["collective_events"] == streams[engine]["events"]
    assert all(v["collective_events"] == 0
               for s, v in streams.items() if s != engine)
    assert dt["serialization"]["n_collectives"] > 0
    assert payload["hlo_stats"]["count"] == 6
    assert set(payload["hlo_stats"]["by_opcode"]) == {"collective-permute"}


# head dim 256 (gemma3): bf16 (wgmma; the forward and dq on 2-stage rings
# with m64n256k16 products, dk/dv split over two warpgroups) and f32 (the
# scalar kernels above 48 KB of shared memory); gemma3's GQA of 2 query
# heads a kv head, windows of 1024 (gemma3's) and 48
D256_CASES = [
    ("bfloat16", True, None, 300),
    ("bfloat16", True, 1024, 1100),
    ("bfloat16", True, 48, 200),
    ("bfloat16", False, None, 130),
    ("float32", True, None, 200),
    ("float32", True, 48, 130),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,causal,window,T", D256_CASES)
def test_head_dim_256_forward_matches_plain_version(dtype, causal, window, T):
    q, k, v, _ = _inputs(dtype, 256, T, B=1, H=4, K=2)
    before = _variants()
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _delta(before) == {
        f"fwd/{'wgmma' if dtype == 'bfloat16' else 'scalar'}": 1}
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
    assert float((out.float() - ref_out.float()).abs().max()) < TOL[dtype]
    assert float((lse - ref_lse).abs().max()) < 1e-3


@pytest.mark.gpu
def test_one_wgmma_product_matches_matmul_at_head_dim_256():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(256)
    a, b, v = (torch.randn(64, 256, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    c1, c2 = kernel.wgmma_probe(a, b, v)
    torch.cuda.synchronize()
    assert _rel(c1, a.float() @ b.float().T) < 1e-4
    assert _rel(c2, c1.to(torch.bfloat16).float() @ v.float()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,causal,window,T", D256_CASES)
def test_head_dim_256_backward_matches_plain_version(dtype, causal, window,
                                                     T):
    q, k, v, do = _inputs(dtype, 256, T, B=1, H=4, K=2)
    out, lse = flash_attention_ref(q, k, v, causal=causal, window=window)
    before = _variants()
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    kind = "wgmma" if dtype == "bfloat16" else "scalar"
    assert _delta(before) == {f"dq/{kind}": 1, f"dkv/{kind}": 1}
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) < GRAD_TOL[dtype], (name, _rel(a, b))


@pytest.mark.gpu
def test_bf16_dq_is_bit_identical_at_head_dim_256():
    q, k, v, do = _inputs("bfloat16", 256, 1100, B=1, H=4, K=2)
    out, lse = flash_attention_ref(q, k, v, window=1024)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    first, second = (kernel.flash_bwd_dq(q, k, v, do, lse.contiguous(), delta,
                                         window=1024) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,changes", [
    ("gemma3-12b", dict(d_head=256, n_heads=2, n_kv_heads=1)),
    ("granite-moe-3b-a800m", dict(n_layers=2)),
    ("deepseek-moe-16b", dict(n_layers=2)),
    ("xlstm-125m", {}),
    ("jamba-v0.1-52b", {}),
])
def test_f32_train_step_on_the_card_matches_cpu(arch, changes):
    """Smoke presets in f32 (gemma3 at head dim 256, windows cut to 8): the
    loss to 1e-4 and every gradient to 1e-3 of its largest value, as
    ``chip_smoke.py`` phase 8 holds yi-6b."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.archs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                              **changes)
    cfg = dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=8 if s.window else None)
        for s in cfg.pattern))
    models = [Model(cfg, torch.device("cuda"), trainable=True).init_weights(0)]
    models.append(Model(cfg, torch.device("cpu"), trainable=True))
    models[1].load_state_dict(models[0].state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(0))
    step = make_train_step(cfg, adamw.AdamWConfig(lr=0.0))
    losses = []
    for m in models:
        batch = {"tokens": toks[:, :-1].to(m.device),
                 "labels": toks[:, 1:].to(m.device)}
        losses.append(float(step(m, adamw.init_state(
            dict(m.named_parameters())), batch)["loss"]))
    assert abs(losses[0] - losses[1]) < 1e-4
    cpu_grads = dict(models[1].named_parameters())
    for name, p in models[0].named_parameters():
        assert _rel(p.grad.cpu(), cpu_grads[name].grad) < 1e-3, name


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-6b", "jamba-v0.1-52b", "gemma3-12b",
                                  "xlstm-125m"])
def test_captured_decode_gives_the_eager_tokens(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.archs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = get_config(arch, "smoke")
    if arch == "gemma3-12b":       # a window that the prompt and decode pass
        cfg = dataclasses.replace(cfg, pattern=tuple(
            dataclasses.replace(s, window=8 if s.window else None)
            for s in cfg.pattern))
    model = Model(cfg, torch.device("cuda")).init_weights(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1)).cuda()
    eager, eager_stats = serve.generate(model, prompts, 6, captured=False)
    graph, graph_stats = serve.generate(model, prompts, 6)
    assert graph_stats["decode_captured"] and not eager_stats["decode_captured"]
    assert torch.equal(graph, eager)
    assert torch.equal(graph_stats["decode_logits"],
                       eager_stats["decode_logits"])


@pytest.mark.gpu
def test_a_traced_captured_call_names_the_capture_stretches():
    """One captured ``generate`` call of the jamba smoke preset under the
    profiler: ``serve/capture`` holds warm-up, begin, record and end in
    order, one ``serve/prefill`` span, the MoE phases as spans, and the
    untraced call's tokens and logits, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.archs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = get_config("jamba-v0.1-52b", "smoke")
    model = Model(cfg, torch.device("cuda")).init_weights(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1)).cuda()
    plain, plain_stats = serve.generate(model, prompts, 4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, stats = serve.generate(model, prompts, 4)
    # the host's spans (the card's copies of them are left out)
    spans = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith(("serve/", "moe/"))),
                   key=lambda e: e.time_range.start)
    names = [e.name for e in spans]
    capture = [e for e in spans if e.name == "serve/capture"]
    assert len(capture) == 1 and names.count("serve/prefill") == 1
    parts = [e for e in spans if e.name.startswith("serve/capture/")]
    assert [e.name for e in parts] == [
        "serve/capture/warmup", "serve/capture/begin",
        "serve/capture/record", "serve/capture/end"]
    lo, hi = capture[0].time_range.start, capture[0].time_range.end
    assert all(lo <= e.time_range.start and e.time_range.end <= hi
               for e in parts)
    assert {"moe/route", "moe/dispatch", "moe/experts",
            "moe/combine"} <= set(names)
    assert torch.equal(traced, plain)
    for key in ("prefill_logits", "decode_logits"):
        assert torch.equal(stats[key], plain_stats[key])


# the selective scan's backward: each gradient against the plain backward
# to the bound of its dtype (f32 1e-4, bf16 2e-2, as max|err| / max|ref|);
# the jamba training shape, a ragged T and dI, and the forward's dtypes
# and state sizes
SCAN_BWD_CASES = [
    (torch.bfloat16, torch.float32, 4, 1024, 8192, 16),
    (torch.bfloat16, torch.float32, 4, 1000, 8000, 16),
    *SCAN_CASES[2:],
]


def _scan_bwd(args, dy):
    """The backward kernel on the forward kernel's saved states."""
    _, _, chunks = scan_kernel.selective_scan(*args, save_chunks=True)
    return scan_kernel.selective_scan_bwd(*args, dy, chunks)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [128, 100])
def test_training_forward_saves_the_plain_states_every_16_steps(T):
    """The states a training forward saves (``save_chunks``): after steps
    16, 32, ... and at T, each the plain scan's final state over that
    prefix, within the final state's bound (1e-4, f32 on both sides); a
    T of 100 ends inside a 16-step run."""
    args = _scan_inputs(torch.float32, torch.float32, 2, T, 192, 16)
    y, h, chunks = scan_kernel.selective_scan(*args, return_state=True,
                                              save_chunks=True)
    torch.cuda.synchronize()
    every = scan_kernel.SAVE_EVERY
    assert chunks.shape == (2, -(-T // every), 192, 16)
    assert torch.equal(chunks[:, -1], h)
    x, dt, A, Bc, Cc, D = args
    for q in range(chunks.shape[1]):
        t = min((q + 1) * every, T)
        _, want = selective_scan_ref(x[:, :t], dt[:, :t], A, Bc[:, :t],
                                     Cc[:, :t], D)
        assert float((chunks[:, q] - want).abs().max()) < 1e-4, q
    y_serve, h_serve, none = scan_kernel.selective_scan(*args,
                                                        return_state=True)
    assert none is None
    assert torch.equal(y_serve, y) and torch.equal(h_serve, h)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,p_dtype,B,T,dI,N", SCAN_BWD_CASES)
def test_cuda_scan_backward_matches_plain_backward(x_dtype, p_dtype, B, T,
                                                   dI, N):
    args = _scan_inputs(x_dtype, p_dtype, B, T, dI, N)
    dy = torch.randn(args[0].shape, device="cuda").to(x_dtype)
    got = _scan_bwd(args, dy)
    torch.cuda.synchronize()
    want = selective_scan_bwd_ref(*args, dy)
    for name, a, b in zip(("dx", "ddt", "dA", "dBc", "dCc", "dD"), got,
                          want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        tol = GRAD_TOL[str(a.dtype).split(".")[-1]]
        assert _rel(a, b) < tol, (name, _rel(a, b))


@pytest.mark.gpu
def test_cuda_scan_backward_is_bit_identical_from_launch_to_launch():
    args = _scan_inputs(torch.bfloat16, torch.float32, 2, 300, 1000, 16)
    dy = torch.randn(args[0].shape, device="cuda").to(torch.bfloat16)
    first, second = _scan_bwd(args, dy), _scan_bwd(args, dy)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_autograd_scan_on_the_card_matches_cpu_and_finite_differences():
    """``SelectiveScan`` in f32 on a small shape: its gradients against the
    CPU's plain backward, and each against a central difference of the
    forward kernel along a random direction (a step of 1e-3 of the input's
    largest value: y is linear in x, B, C and D, and exp(dt A) over 70
    steps is curved enough in dt and A that a step of 1e-2 is 6% off)."""
    args = _scan_inputs(torch.float32, torch.float32, 2, 70, 96, 8)
    w = torch.randn(args[0].shape, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in args]
    bwd = selective_scan.bwd_launches
    y, _ = SelectiveScan.apply(*leaves)
    (y * w).sum().backward()
    assert selective_scan.bwd_launches == bwd + 1
    cpu = [t.detach().cpu().requires_grad_(True) for t in args]
    (SelectiveScan.apply(*cpu)[0] * w.cpu()).sum().backward()
    for i, (a, b) in enumerate(zip(leaves, cpu)):
        assert _rel(a.grad.cpu(), b.grad) < 1e-4, i
    gen = torch.Generator(device="cuda").manual_seed(5)
    for i, t in enumerate(args):
        v = torch.randn(t.shape, generator=gen, device="cuda")
        eps = 1e-3 * float(t.abs().max())
        loss = lambda s: float(
            (scan_kernel.selective_scan(*[u + s * eps * v if k == i else u
                                          for k, u in enumerate(args)])[0]
             .double() * w.double()).sum())
        fd = (loss(1) - loss(-1)) / (2 * eps)
        an = float((leaves[i].grad.double() * v.double()).sum())
        assert abs(fd - an) < 1e-2 * max(abs(an), 1e-3), (i, fd, an)


@pytest.mark.gpu
def test_scan_backward_raises_before_any_launch():
    args = _scan_inputs(torch.bfloat16, torch.float32, 2, 64, 128, 16)
    _, _, chunks = scan_kernel.selective_scan(*args, save_chunks=True)
    dy = torch.randn(args[0].shape, device="cuda").to(torch.bfloat16)
    x = args[0]
    strided = torch.empty(2, 64, 256, device="cuda",
                          dtype=x.dtype)[..., ::2].copy_(x)
    bad = [
        ((strided, *args[1:]), dy, chunks),          # no unit stride over dI
        (args, dy.float(), chunks),                   # dy not in x's dtype
        (args, dy, chunks[:, 1:]),                    # too few saved states
        (args, dy, chunks.to(torch.bfloat16)),        # states not f32
        ((x, args[1].double(), *args[2:]), dy, chunks),
    ]
    for call_args, d, c in bad:
        with pytest.raises(ValueError):
            scan_kernel.selective_scan_bwd(*call_args, d, c)


@pytest.mark.gpu
@pytest.mark.parametrize("D,T,S,G,K", [
    (128, 256, 1024, 4, 8),      # the vlm's cross-attention, cut in B and T
    (128, 100, 160, 4, 2),       # ragged against the tiles on both sides
    (64, 200, 330, 1, 4),        # head dim 64, one query head a kv head
])
def test_cross_attention_shape_through_autograd(D, T, S, G, K):
    """Non-causal, T queries against S != T keys, as the gated
    cross-attention runs it: forward, dq and dk/dv through
    ``FlashAttention`` against the plain versions, counted as non-causal."""
    q, k, v, do = _bf16_inputs(D, T, G, S=S, K=K)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = dict(flash_attention.launches_by_shape)
    out, _ = FlashAttention.apply(q, k, v, False, None)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    after = flash_attention.launches_by_shape
    assert {key: n - before[key] for key, n in after.items()
            if n != before[key]} == {f"{name}/{D}/non-causal": 1
                                     for name in ("fwd", "dq", "dkv")}
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal=False)
    assert float((out.float() - ref_out.float()).abs().max()) < TOL["bfloat16"]
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                   ref_out.detach(), ref_lse, do,
                                   causal=False)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) < GRAD_TOL["bfloat16"], (name, _rel(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,changes", [
    ("llama-3.2-vision-11b", {}),
    ("musicgen-large", dict(n_layers=2)),
])
def test_f32_vlm_and_audio_train_step_on_the_card_matches_cpu(arch, changes):
    """Smoke presets in f32, the cross-attention gate at 0.5 (at its init
    of 0 the sublayer and its gradients are zero): the loss to 1e-4 and
    every gradient to 1e-3 of its largest value, the cross-attention's
    projections with non-zero gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from repro_torch.configs.archs import get_config
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                              **changes)
    models = [Model(cfg, torch.device("cuda"), trainable=True).init_weights(0)]
    with torch.no_grad():
        for n, p in models[0].named_parameters():
            if n.endswith(".gate"):
                p.fill_(0.5)
    models.append(Model(cfg, torch.device("cpu"), trainable=True))
    models[1].load_state_dict(models[0].state_dict())
    rng = np.random.default_rng(0)
    B, T = 2, 40
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, T, cfg.n_codebooks)
                                    if cfg.input_mode == "frames" else (B, T))}
    if cfg.input_mode == "frames":
        batch["frames"] = rng.standard_normal((B, T, cfg.d_model),
                                              dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, T))
        batch["encoder_embeddings"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model), dtype=np.float32)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=0.0))
    losses = [float(step(m, adamw.init_state(dict(m.named_parameters())),
                         to_device(batch, m.device))["loss"])
              for m in models]
    assert abs(losses[0] - losses[1]) < 1e-4
    cpu_grads = dict(models[1].named_parameters())
    for name, p in models[0].named_parameters():
        assert _rel(p.grad.cpu(), cpu_grads[name].grad) < 1e-3, name
        if ".cross.w" in name:
            assert float(p.grad.abs().max()) > 0, name


@pytest.mark.gpu
def test_a_real_cuda_tensor_never_reaches_the_fake_branch():
    """The wrappers' branch for fake tensors (the dry run's) is taken
    only for fake tensors: a real CUDA tensor launches the kernels and
    leaves ``fake_launches_by_shape`` as it found it."""
    q, k, v, do = _inputs("bfloat16", 128, 256)
    fake = dict(flash_attention.fake_launches_by_shape)
    launches = (flash_attention.launches, flash_attention.bwd_dq_launches,
                flash_attention.bwd_dkv_launches)
    out, lse = flash_attention(q, k, v)
    flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches) == tuple(n + 1 for n in launches)
    assert flash_attention.fake_launches_by_shape == fake


@pytest.mark.gpu
def test_a_real_cuda_tensor_never_takes_the_scans_fake_branch():
    """The scan's branch for fake tensors is taken only for fake tensors:
    a real CUDA tensor launches the forward and backward kernels and
    leaves ``fake_launches`` and ``fake_bwd_launches`` as it found them."""
    args = [a.requires_grad_(True) for a in
            _scan_inputs(torch.float32, torch.float32, 2, 64, 256, 16)]
    counts = lambda: (selective_scan.launches, selective_scan.bwd_launches,
                      selective_scan.fake_launches,
                      selective_scan.fake_bwd_launches)
    before = counts()
    y, _h = SelectiveScan.apply(*args)
    y.sum().backward()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2], before[3])


# ---------------------------------------------------------------------------
# decode attention: one query position against the KV cache
# ---------------------------------------------------------------------------

# decode attention in bf16: max|err| / max|ref| against the plain version
# in f32 from the same inputs. The output's own bf16 rounding is 2**-9 of
# it; P.V carries p to ~16 bits, the sums are f32.
DECODE_BF16_REL = 1e-2


def _decode_inputs(dtype, B, S, K, G, D, pos, seed=0):
    """q (B, 1, K, G, D) and caches (B, S, K, D) of ``dtype``, a global
    layer's positions for a query at ``pos`` (slots 0..pos filled; past
    the cache, slot S - 1 holds pos, as a decode step's clamp writes it)
    and the 0-d position on the card. q is 4 times a standard normal, so
    that the scores spread (std 4) and a few slots carry the softmax."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = (4 * torch.randn((B, 1, K, G, D), generator=gen,
                         device="cuda")).to(dt)
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    pos_k = torch.full((S,), -1, dtype=torch.int32, device="cuda")
    pos_k[:min(pos, S - 1) + 1] = torch.arange(min(pos, S - 1) + 1,
                                               dtype=torch.int32)
    pos_k[S - 1] = pos if pos >= S - 1 else -1
    return q, k, v, pos_k, torch.full((), pos, dtype=torch.int32,
                                      device="cuda")


def _decode_check(q, k, v, pos_k, pos_q, window=None):
    """The kernel against the plain version (f32 from the same inputs):
    f32 max|err| below the forward's bound, bf16 max|err| / max|ref|
    below :data:`DECODE_BF16_REL`; one launch."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    before = decode_attention.launches
    out = decode_attention(q, k, v, pos_k, pos_q, window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == k.dtype and out.shape == q.shape
    want = decode_attention_ref(q.float(), k.float(), v.float(), pos_k, pos_q,
                                window)
    err = float((out.float() - want).abs().max())
    if k.dtype == torch.bfloat16:
        assert err / float(want.abs().max()) < DECODE_BF16_REL, err
    else:
        assert err < TOL["float32"], err
    return out


# the cells' shapes (yi-6b: K 4, G 8, D 128): decode_b32 and prefill_mix's
# longest; positions 0, mid, S - 2 and past the cache (slot S - 1 clamped)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(32, 1280), (4, 4112)])
@pytest.mark.parametrize("where", ["first", "mid", "last", "clamped"])
def test_decode_attention_matches_plain_version_at_the_cells_shapes(
        dtype, B, S, where):
    pos = {"first": 0, "mid": S // 2 + 3, "last": S - 2,
           "clamped": S + 5}[where]
    _decode_check(*_decode_inputs(dtype, B, S, 4, 8, 128, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(32, 1280), (4, 4112)])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_decode_attention_reads_every_filled_slot_and_no_more(dtype, B, S,
                                                              where):
    """A global layer: the last filled slot's key points along the sum of
    its group's queries, so that it carries about as much of the softmax
    as all the others, and a kernel that stops a slot or a tile short is
    off by about |v|; NaN in every slot past it leaves the output as it
    was, bit for bit."""
    from repro_torch.kernels.decode_attention.ops import decode_attention

    pos = {"first": 0, "mid": S // 2 + 3, "last": S - 2}[where]
    q, k, v, pos_k, pos_q = _decode_inputs(dtype, B, S, 4, 8, 128, pos)
    u = q.float().sum(dim=3)[:, 0]                     # (B, K, D)
    k[:, pos] = (128 ** 0.5 * u / u.norm(dim=-1, keepdim=True)).to(k.dtype)
    clean = _decode_check(q, k, v, pos_k, pos_q)
    k[:, pos + 1:], v[:, pos + 1:] = float("nan"), float("nan")
    out = decode_attention(q, k, v, pos_k, pos_q)
    torch.cuda.synchronize()
    assert torch.equal(out, clean)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
def test_decode_attention_every_head_dim_and_group(dtype, D, G):
    _decode_check(*_decode_inputs(dtype, 3, 300, 2, G, D, 250, seed=D + G))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(64, 64), (80, 48)])
def test_decode_attention_on_a_wrapped_ring(dtype, S, window):
    """A windowed layer's ring after it wrapped: slot s holds the last
    position p <= pos with p % S == s; the window masks what it passed."""
    q, k, v, _, _ = _decode_inputs(dtype, 2, S, 2, 4, 128, 0)
    pos = 150
    pos_k = torch.tensor([max(p for p in range(pos + 1) if p % S == s)
                          for s in range(S)], dtype=torch.int32,
                         device="cuda")
    _decode_check(q, k, v, pos_k, torch.full((), pos, dtype=torch.int32,
                                             device="cuda"), window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_reads_an_all_valid_cross_cache(dtype):
    """The cross-attention's cache: every one of N slots valid, the query
    at 2**30, as ``cross_from_cache`` passes them."""
    q, k, v, _, _ = _decode_inputs(dtype, 2, 200, 1, 8, 128, 0)
    pos_k = torch.arange(200, dtype=torch.int32, device="cuda")
    _decode_check(q, k, v, pos_k, torch.full((), 2 ** 30, dtype=torch.int32,
                                             device="cuda"))


@pytest.mark.gpu
def test_decode_attention_replays_in_a_graph_at_any_position():
    """Captured once at position 0, replayed at several positions: equal
    to eager calls bit for bit, and counted once (the capture) however
    often the graph replays."""
    from repro_torch.kernels.decode_attention.ops import decode_attention

    q, k, v, pos_k, pos_q = _decode_inputs("bfloat16", 4, 600, 4, 8, 128,
                                           599)
    pos_k.copy_(torch.arange(600, dtype=torch.int32))
    static = torch.zeros((), dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, k, v, pos_k, static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = decode_attention.launches
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, pos_k, static)
    for pos in (0, 17, 300, 599):
        static.fill_(pos)
        graph.replay()
        want = decode_attention(q, k, v, pos_k, torch.full(
            (), pos, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        assert torch.equal(out, want), pos
    assert decode_attention.launches == before + 1 + 4


@pytest.mark.gpu
def test_decode_attention_is_bit_identical_from_launch_to_launch():
    args = _decode_inputs("bfloat16", 4, 4112, 4, 8, 128, 4100)
    from repro_torch.kernels.decode_attention.ops import decode_attention

    first, second = decode_attention(*args), decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["head_dim", "group", "dtype", "stride",
                                  "positions"])
def test_decode_attention_refuses_what_it_does_not_take(what):
    from repro_torch.kernels.decode_attention.ops import decode_attention

    D = 32 if what == "head_dim" else 128
    G = 9 if what == "group" else 8
    dtype = "float16" if what == "dtype" else "bfloat16"
    q, k, v, pos_k, pos_q = _decode_inputs(dtype, 2, 64, 2, G, D, 40)
    if what == "stride":        # a cache whose slots are 136 * 2 B apart
        k = torch.zeros((2, 64, 2, D + 8), dtype=k.dtype,
                        device="cuda")[..., 4:D + 4]
    if what == "positions":
        pos_k = pos_k.long()
    before = decode_attention.launches
    with pytest.raises(ValueError):
        decode_attention(q, k, v, pos_k, pos_q)
    assert decode_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-12b"])
def test_generate_runs_decode_attention_in_the_graph(arch):
    """A captured call launches the kernels three times an attention layer
    (two warm-up steps and the captured step); eager decode once a layer
    a step; and the tokens agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.archs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = get_config(arch, "smoke")
    if arch == "gemma3-12b":       # a window that the prompt and decode pass
        cfg = dataclasses.replace(cfg, pattern=tuple(
            dataclasses.replace(s, window=8 if s.window else None)
            for s in cfg.pattern))
    n_attn = sum(s.mixer == "attn" for s in cfg.pattern) * cfg.n_groups
    model = Model(cfg, torch.device("cuda")).init_weights(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1)).cuda()
    graph, stats = serve.generate(model, prompts, 6)
    eager, eager_stats = serve.generate(model, prompts, 6, captured=False)
    assert stats["decode_attention_launches"] == 3 * n_attn
    assert eager_stats["decode_attention_launches"] == 6 * n_attn
    assert torch.equal(graph, eager)
