"""The port's flash-attention forward against the JAX package's Pallas
kernel (interpret mode) and its ``mha_reference``.

On the CPU the port's wrapper takes its plain version
(``tests/test_torch_kernels_gpu.py`` holds the CUDA kernel to it on the
card). Inputs are made with numpy from a seed and handed to both
frameworks. Tolerances are those of ``tests/test_kernels_flash.py``:
f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import kernel as cuda_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(shapes, dtype, seed=0):
    """Same values in both frameworks: numpy f32 -> each one's dtype."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def bhtd(x):
    return x.transpose(0, 2, 1, 3)


def max_err(a, b):
    return float(np.abs(to_np(a) - to_np(b)).max())


@pytest.mark.parametrize("B,T,H,D", [
    (1, 128, 1, 64), (2, 256, 4, 64), (1, 128, 2, 128), (1, 64, 8, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel(B, T, H, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = inputs([(B, T, H, D)] * 3, dtype)
    j_out, j_lse = flash_attention_fwd(bhtd(jq), bhtd(jk), bhtd(jv),
                                       block_q=64, block_k=64, interpret=True)
    out, lse = flash_attention(tq, tk, tv)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    assert max_err(out, bhtd(j_out)) < TOL[dtype]
    assert max_err(lse, j_lse) < TOL[dtype]


@pytest.mark.parametrize("causal,window", [
    (False, None), (True, 32), (True, 64), (True, 100),
])
def test_masks_match_pallas_kernel(causal, window):
    B, T, H, D = 1, 256, 2, 64
    (jq, jk, jv), (tq, tk, tv) = inputs([(B, T, H, D)] * 3, "float32", 1)
    j_out, j_lse = flash_attention_fwd(
        bhtd(jq), bhtd(jk), bhtd(jv), causal=causal, window=window,
        block_q=64, block_k=64, interpret=True)
    out, lse = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert max_err(out, bhtd(j_out)) < 2e-5
    assert max_err(lse, j_lse) < 2e-5


def test_gqa_matches_jax_ops():
    B, T, H, K, D = 2, 128, 8, 2, 64
    (jq, jk, jv), (tq, tk, tv) = inputs(
        [(B, T, H, D), (B, T, K, D), (B, T, K, D)], "float32", 2)
    ref = jax_flash(jq, jk, jv, block_q=64, block_k=64)
    out, _ = flash_attention(tq, tk, tv)
    assert max_err(out, ref) < 2e-5


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_mha_reference(causal):
    B, T, H, D = 2, 100, 2, 32
    (jq, jk, jv), (tq, tk, tv) = inputs([(B, T, H, D)] * 3, "float32", 3)
    ref = mha_reference(jq, jk, jv, causal=causal)
    out, _ = flash_attention(tq, tk, tv, causal=causal)
    assert max_err(out, ref) < 2e-5


def test_cpu_tensors_do_not_launch_the_kernel():
    _, (tq, tk, tv) = inputs([(1, 64, 2, 32)] * 3, "float32")
    before = flash_attention.launches
    flash_attention(tq, tk, tv)
    assert flash_attention.launches == before == 0


@pytest.mark.parametrize("q_shape,kv_shape,kw", [
    ((1, 64, 2, 32), (1, 32, 2, 32), {}),              # causal needs T == S
    ((1, 64, 3, 32), (1, 64, 2, 32), {}),              # K must divide H
    ((1, 64, 2, 32), (1, 64, 2, 16), {}),              # head dims differ
    ((1, 64, 2, 32), (1, 64, 2, 32), {"window": 0}),   # window >= 1
])
def test_wrapper_rejects_bad_arguments(q_shape, kv_shape, kw):
    q = torch.zeros(q_shape)
    k = torch.zeros(kv_shape)
    with pytest.raises(ValueError):
        flash_attention(q, k, k.clone(), **kw)


def test_kernel_binding_refuses_cpu_tensors_without_building(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    x = torch.zeros(1, 32, 2, 32)
    with pytest.raises(ValueError):
        cuda_kernel.flash_fwd(x, x, x)
    assert list(tmp_path.iterdir()) == []


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild.shutil, "which", lambda _name: None)
    monkeypatch.setattr(kbuild, "_CUDA_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kbuild.build()
