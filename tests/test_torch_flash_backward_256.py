"""Head dim 256 (gemma3) in the port's flash-attention backward, against the
JAX package.

The plain backward, which the dq and dk/dv kernels are held to on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 25), is held
here to the Pallas ``flash_attention_bwd`` in interpret mode at D = 256:
causal, a window of 32, and GQA with G = 2 query heads a kv head. The Pallas
kernels take one kv head a query head, so they get k and v repeated to H
heads and their dk, dv are summed over each group, as the VJP of the JAX
wrapper's ``jnp.repeat`` sums them. Inputs are made with numpy from a seed.
Bounds as ``tests/test_torch_flash_backward.py``: max|err| / max|ref| below
1e-4 in f32, 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                  flash_attention_fwd)
from repro_torch.kernels.flash_attention import kernel as cuda_kernel
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     flash_attention,
                                                     flash_attention_bwd as
                                                     port_bwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

REL = {"float32": 1e-4, "bfloat16": 2e-2}
B, T, H, K, D = 1, 128, 4, 2, 256


def inputs(dtype, seed):
    """q, do (B,T,H,D), k, v (B,T,K,D): the same values in both
    frameworks, numpy f32 -> each one's dtype."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, D), (B, T, K, D), (B, T, K, D), (B, T, H, D))]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def rel_err(a, b):
    a, b = to_np(a), to_np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def bhtd(x):
    return x.transpose(0, 2, 1, 3)


def pallas(jq, jk, jv, jdo, window):
    """(out, lse, dq, dk, dv) of the Pallas kernels in the model layout, kv
    heads repeated to H for them and dk, dv summed back over each group."""
    G = H // K
    q, do = bhtd(jq), bhtd(jdo)
    k, v = (jnp.repeat(bhtd(x), G, axis=1) for x in (jk, jv))
    out, lse = flash_attention_fwd(q, k, v, causal=True, window=window,
                                   block_q=64, block_k=64, interpret=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                     window=window, block_q=64, block_k=64,
                                     interpret=True)

    def group_sum(x):                     # (B, H, T, D) -> (B, T, K, D)
        x = bhtd(x.astype(jnp.float32))
        return x.reshape(B, T, K, G, D).sum(3)

    return bhtd(out), lse, bhtd(dq), group_sum(dk), group_sum(dv)


@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_at_head_dim_256_matches_pallas_kernels(window, dtype):
    jx, (tq, tk, tv, tdo) = inputs(dtype, seed=256 + (window or 0))
    out, lse, *want = pallas(*jx, window)
    t_out = torch.from_numpy(np.array(to_np(out))).to(tq.dtype)
    got = flash_attention_bwd_ref(tq, tk, tv, t_out,
                                  torch.from_numpy(np.array(lse)), tdo,
                                  window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tq.dtype and a.shape == tuple(b.shape), name
        assert rel_err(a, b) < REL[dtype], (name, rel_err(a, b))


@pytest.mark.parametrize("window", [None, 32])
def test_autograd_function_at_head_dim_256_matches_autograd_of_plain_forward(
        window):
    _, (tq, tk, tv, tdo) = inputs("float32", seed=7)
    grads = []
    for fn in (lambda *x: FlashAttention.apply(*x, True, window),
               lambda *x: flash_attention_ref(*x, window=window)):
        leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
        out, _ = fn(*leaves)
        grads.append(torch.autograd.grad(out, leaves, tdo))
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        assert rel_err(a, b) < 1e-4, (name, rel_err(a, b))


def test_cpu_backward_at_head_dim_256_counts_no_launch():
    _, (tq, tk, tv, tdo) = inputs("float32", seed=3)
    before = dict(flash_attention.launches_by_shape)
    out, lse = flash_attention(tq, tk, tv, window=32)
    port_bwd(tq, tk, tv, out, lse, tdo, window=32)
    assert flash_attention.launches_by_shape == before
    assert {"fwd/256/causal", "dq/256/causal", "dkv/256/causal"} <= set(before)


@pytest.mark.parametrize("fn", ["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_take_head_dim_256_up_to_the_device_check(fn, dtype):
    assert 256 in cuda_kernel.HEAD_DIMS["dq"]
    assert 256 in cuda_kernel.HEAD_DIMS["dkv"]
    x = torch.zeros(1, 64, 2, 256, dtype=dtype)
    rows = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(cuda_kernel, fn)(x, x, x, x, rows, rows)
