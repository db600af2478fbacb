"""The port's flash-attention backward against the JAX package.

On the CPU the port's wrappers take their plain versions
(``tests/test_torch_kernels_gpu.py`` holds the CUDA kernels to them on the
card). The plain backward is held to the Pallas ``flash_attention_bwd`` in
interpret mode, its GQA reduction to ``jax.vjp`` through the JAX
``flash_attention`` (which repeats kv heads and lets the repeat's VJP sum
them), and the autograd function to torch autograd through the plain
forward. Inputs are made with numpy from a seed. Bounds: max|err| /
max|ref| below 1e-4 in f32 (``tests/test_kernels_flash.py``), 2e-2 in bf16,
whose gradients round to 8 bits of mantissa.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                  flash_attention_fwd)
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import kernel as cuda_kernel
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_bwd as port_bwd
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

REL = {"float32": 1e-4, "bfloat16": 2e-2}


def inputs(shapes, dtype, seed=0):
    """Same values in both frameworks: numpy f32 -> each one's dtype."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def to_torch(x, dtype):
    return torch.from_numpy(np.array(to_np(x))).to(getattr(torch, dtype))


def bhtd(x):
    return x.transpose(0, 2, 1, 3)


def rel_err(a, b):
    a, b = to_np(a), to_np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def pallas_grads(jq, jk, jv, jdo, causal=True, window=None):
    """(out, lse, dq, dk, dv) of the Pallas kernels, in the model layout."""
    q, k, v, do = (bhtd(x) for x in (jq, jk, jv, jdo))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   block_q=64, block_k=64, interpret=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                     window=window, block_q=64, block_k=64,
                                     interpret=True)
    return bhtd(out), lse, bhtd(dq), bhtd(dk), bhtd(dv)


@pytest.mark.parametrize("B,T,H,D", [
    (1, 128, 1, 64), (2, 256, 4, 64), (1, 128, 2, 128), (1, 64, 8, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_kernels(B, T, H, D, dtype):
    jx, (tq, tk, tv, tdo) = inputs([(B, T, H, D)] * 4, dtype)
    out, lse, *want = pallas_grads(*jx)
    got = flash_attention_bwd_ref(tq, tk, tv, to_torch(out, dtype),
                                  torch.from_numpy(np.array(lse)), tdo)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tq.dtype and a.shape == tuple(b.shape), name
        assert rel_err(a, b) < REL[dtype], (name, rel_err(a, b))


@pytest.mark.parametrize("causal,window", [
    (False, None), (True, 32), (True, 64), (True, 100),
])
def test_plain_backward_masks_match_pallas_kernels(causal, window):
    jx, (tq, tk, tv, tdo) = inputs([(1, 256, 2, 64)] * 4, "float32", 1)
    out, lse, *want = pallas_grads(*jx, causal=causal, window=window)
    got = flash_attention_bwd_ref(tq, tk, tv, to_torch(out, "float32"),
                                  torch.from_numpy(np.array(lse)), tdo,
                                  causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert rel_err(a, b) < 1e-4, (name, rel_err(a, b))


def test_gqa_gradients_match_jax_vjp():
    B, T, H, K, D = 2, 128, 8, 2, 64
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = inputs(
        [(B, T, H, D), (B, T, K, D), (B, T, K, D), (B, T, H, D)],
        "float32", 2)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, block_q=64, block_k=64),
        jq, jk, jv)
    want = vjp(jdo)
    leaves = [x.requires_grad_() for x in (tq, tk, tv)]
    out, _ = FlashAttention.apply(*leaves, True, None)
    got = torch.autograd.grad(out, leaves, tdo)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        assert rel_err(a, b) < 1e-4, (name, rel_err(a, b))


@pytest.mark.parametrize("T,H,K,D,causal,window,dtype", [
    (64, 4, 4, 32, True, None, "float32"),
    (100, 8, 2, 32, True, None, "float32"),     # ragged, GQA
    (96, 4, 2, 64, True, 20, "float32"),        # window
    (80, 4, 1, 32, False, None, "float32"),     # non-causal, one kv head
    (50, 2, 1, 32, False, 7, "float32"),        # window without causal
    (64, 8, 2, 64, True, None, "bfloat16"),
])
def test_autograd_function_matches_autograd_of_plain_forward(
        T, H, K, D, causal, window, dtype):
    _, (tq, tk, tv, tdo) = inputs(
        [(2, T, H, D), (2, T, K, D), (2, T, K, D), (2, T, H, D)], dtype, T)
    grads = []
    for fn in (lambda *x: FlashAttention.apply(*x, causal, window),
               lambda *x: flash_attention_ref(*x, causal=causal,
                                              window=window)):
        leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
        out, lse = fn(*leaves)
        grads.append(torch.autograd.grad(out, leaves, tdo))
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        assert a.dtype == b.dtype, name
        assert rel_err(a, b) < REL[dtype], (name, rel_err(a, b))


def test_lse_is_not_differentiable():
    _, (tq, tk, tv) = inputs([(1, 32, 2, 32)] * 3, "float32")
    out, lse = FlashAttention.apply(tq.requires_grad_(), tk, tv, True, None)
    assert out.requires_grad and not lse.requires_grad


def test_cpu_tensors_launch_no_backward_kernel():
    _, (tq, tk, tv, tdo) = inputs([(1, 64, 2, 32)] * 4, "float32")
    out, lse = flash_attention(tq, tk, tv)
    before = (flash_attention.launches, flash_attention.bwd_dq_launches,
              flash_attention.bwd_dkv_launches)
    port_bwd(tq, tk, tv, out, lse, tdo)
    after = (flash_attention.launches, flash_attention.bwd_dq_launches,
             flash_attention.bwd_dkv_launches)
    assert before == after == (0, 0, 0)


def test_backward_rejects_bad_arguments():
    x = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError):
        port_bwd(x, x[:, :32], x[:, :32], x, torch.zeros(1, 2, 64), x)
    with pytest.raises(ValueError):
        port_bwd(x, x, x, x, torch.zeros(1, 2, 64), x, window=0)


@pytest.mark.parametrize("fn", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_bindings_refuse_cpu_tensors_without_building(
        fn, tmp_path, monkeypatch):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    x = torch.zeros(1, 32, 2, 32)
    rows = torch.zeros(1, 2, 32)
    with pytest.raises(ValueError):
        getattr(cuda_kernel, fn)(x, x, x, x, rows, rows)
    assert list(tmp_path.iterdir()) == []


def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_compiles_each_source_once_into_its_own_library(
        tmp_path, monkeypatch):
    # a stand-in compiler that writes its -o argument and logs its source
    nvcc = _fake_nvcc(tmp_path, 'out=""; prev=""\nfor a in "$@"; do\n'
                      '  [ "$prev" = "-o" ] && out="$a"; prev="$a"\ndone\n'
                      'echo "compiled $a"\necho lib > "$out"\n')
    build = tmp_path / "build"
    monkeypatch.setattr(kbuild, "BUILD_DIR", build)
    monkeypatch.setattr(kbuild, "_nvcc", lambda: nvcc)
    libs = kbuild.build()
    assert sorted(libs) == ["flash_bwd", "flash_fwd", "selective_scan"]
    for name, lib in libs.items():
        assert lib.exists() and lib.name.startswith(f"lib{name}_")
        assert f"{name}.cu" in lib.with_suffix(".log").read_text()
    monkeypatch.setattr(kbuild, "_nvcc", lambda: "/no/such/nvcc")
    assert kbuild.build() == libs            # nothing left to build
    assert sorted(os.listdir(build)) == sorted(
        [p.name for p in libs.values()]
        + [p.with_suffix(".log").name for p in libs.values()])


def test_failed_build_names_the_source_and_leaves_no_library(
        tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: bad code" >&2\nexit 2\n')
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kbuild, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="flash_bwd.cu"):
        kbuild.build()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
