"""The port's selective scan and mamba mixer against the JAX package.

Inputs are made with numpy from a seed and go through both packages in f32
(bf16 where named). Bounds are those of ``tests/test_kernels_mamba.py``: y
within 1e-4 in f32 and 5e-2 in bf16. The JAX Pallas kernel runs in
interpret mode, as its own tests run it on the CPU; the port takes the
plain version of its CUDA kernel on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.kernels.mamba_scan.ops import mamba_scan
from repro.kernels.mamba_scan.ref import selective_scan_reference
from repro.models import mamba as jax_mamba
from repro_torch.configs import archs as torch_archs
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.models import mamba

CPU = torch.device("cpu")


def scan_inputs(B, T, dI, N, seed=7):
    """The distribution of ``tests/test_kernels_mamba.py``, from numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, T, dI)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, dI)) - 2)).astype(f)
    A = -np.exp(rng.standard_normal((dI, N)) * 0.5).astype(f)
    Bc = rng.standard_normal((B, T, N)).astype(f)
    Cc = rng.standard_normal((B, T, N)).astype(f)
    D = rng.standard_normal(dI).astype(f)
    return x, dt, A, Bc, Cc, D


def to_torch(arrays, dtype=torch.float32):
    """x, dt, Bc, Cc in ``dtype``; A and D stay f32."""
    x, dt, A, Bc, Cc, D = (torch.from_numpy(a) for a in arrays)
    return (x.to(dtype), dt.to(dtype), A, Bc.to(dtype), Cc.to(dtype), D)


def to_jax(arrays, dtype=jnp.float32):
    x, dt, A, Bc, Cc, D = (jnp.asarray(a) for a in arrays)
    return (x.astype(dtype), dt.astype(dtype), A, Bc.astype(dtype),
            Cc.astype(dtype), D)


@pytest.mark.parametrize("B,T,dI,N", [
    (1, 32, 64, 4), (2, 64, 128, 8), (1, 128, 64, 16),
])
def test_scan_matches_jax_reference_and_pallas_kernel(B, T, dI, N):
    arrays = scan_inputs(B, T, dI, N)
    y = selective_scan(*to_torch(arrays)).numpy()
    ref = np.asarray(selective_scan_reference(*to_jax(arrays)))
    pallas = np.asarray(mamba_scan(*to_jax(arrays), block_d=32, block_t=32))
    assert float(np.abs(y - ref).max()) < 1e-4
    assert float(np.abs(y - pallas).max()) < 1e-4


def test_scan_bf16_inputs_match_pallas_kernel():
    arrays = scan_inputs(1, 64, 64, 8)
    y = selective_scan(*to_torch(arrays, torch.bfloat16))
    assert y.dtype == torch.bfloat16
    pallas = mamba_scan(*to_jax(arrays, jnp.bfloat16), block_d=32, block_t=32)
    ref = selective_scan_reference(*to_jax(arrays, jnp.bfloat16))
    y = y.float().numpy()
    assert float(np.abs(y - np.asarray(pallas.astype(jnp.float32))).max()) < 5e-2
    assert float(np.abs(y - np.asarray(ref)).max()) < 5e-2


def test_scan_state_carries_across_time():
    # as tests/test_kernels_mamba.py: y at t >= 32 depends on x at t = 0
    x, dt, A, Bc, Cc, D = to_torch(scan_inputs(1, 64, 32, 4))
    out1 = selective_scan(x, dt, A, Bc, Cc, D)
    x2 = x.clone()
    x2[:, 0] += 10.0
    out2 = selective_scan(x2, dt, A, Bc, Cc, D)
    assert float((out1[:, 32:] - out2[:, 32:]).abs().max()) > 0


def test_final_state_is_the_last_of_single_steps():
    x, dt, A, Bc, Cc, D = scan_inputs(2, 40, 16, 8, seed=3)
    y, h = selective_scan(*to_torch((x, dt, A, Bc, Cc, D)), return_state=True)
    assert h.shape == (2, 16, 8) and h.dtype == torch.float32
    state = np.zeros((2, 16, 8), np.float32)
    for t in range(x.shape[1]):
        state = (np.exp(dt[:, t, :, None] * A) * state
                 + (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :])
        y_t = (state * Cc[:, t, None, :]).sum(-1) + D * x[:, t]
        assert float(np.abs(y[:, t].numpy() - y_t).max()) < 1e-5
    assert float(np.abs(h.numpy() - state).max()) < 1e-5


def test_scan_rejects_a_device_other_than_cuda_or_cpu():
    x, dt, A, Bc, Cc, D = to_torch(scan_inputs(1, 4, 8, 4))
    with pytest.raises(ValueError):
        selective_scan(*(t.to("meta") for t in (x, dt, A, Bc, Cc, D)))


# ---------------------------------------------------------------------------
# mamba_apply
# ---------------------------------------------------------------------------

def configs():
    """The jamba smoke preset in both packages, f32: d_model 64, d_inner
    128, d_state 4, d_conv 4, dt_rank 4."""
    j = dataclasses.replace(jax_archs.get_config("jamba-v0.1-52b", "smoke"),
                            dtype="float32")
    t = dataclasses.replace(torch_archs.get_config("jamba-v0.1-52b", "smoke"),
                            dtype="float32")
    return j, t


def mixer_params(cfg, seed=0):
    """numpy weights for one mamba mixer, sized so that the state and the
    conv tail matter to the output."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jax_mamba.mamba_specs(cfg).items():
        a = rng.standard_normal(spec.shape) * 0.2
        if name == "A_log":
            a = np.log(np.arange(1, spec.shape[-1] + 1))[None] + a
        elif name == "dt_b":
            a = a - 2.0
        out[name] = a.astype(np.float32)
    return out


def both(params):
    j = {k: jnp.asarray(v) for k, v in params.items()}
    t = {k: tensor_from_numpy(v, CPU) for k, v in params.items()}
    return j, t


def hidden(B, T, E, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, E)).astype(
        np.float32)


@pytest.mark.parametrize("T", [24, 128, 256])
def test_prefill_matches_jax(T):
    jcfg, tcfg = configs()
    jp, tp = both(mixer_params(jcfg))
    x = hidden(2, T, jcfg.d_model)
    j_out, j_cache = jax_mamba.mamba_apply(jp, jnp.asarray(x), jcfg,
                                           mode="prefill")
    cache = mamba.alloc_cache(tcfg, 2, CPU)
    out = mamba.mamba_apply(tp, torch.from_numpy(x), tcfg, cache,
                            mode="prefill")
    assert float(np.abs(out.numpy() - np.asarray(j_out)).max()) < 1e-4
    # the conv tail is raw in_proj output: matmuls sum in their own order
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(j_cache["conv"]), rtol=0, atol=1e-5)
    # T <= 128 or a multiple of 128: the JAX scan pads no step
    assert float(np.abs(cache["h"].numpy() - np.asarray(j_cache["h"])).max()
                 ) < 1e-5


def jax_decode_chain(jp, jcfg, x):
    """The state after feeding x one token at a time through JAX's decode
    step from a zero cache."""
    dI = jcfg.mamba.expand * jcfg.d_model
    B = x.shape[0]
    cache = {"h": jnp.zeros((B, dI, jcfg.mamba.d_state), jnp.float32),
             "conv": jnp.zeros((B, jcfg.mamba.d_conv - 1, dI), jnp.float32)}
    for t in range(x.shape[1]):
        _, cache = jax_mamba.mamba_apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                         cache=cache, mode="decode")
    return cache


def test_prefill_state_at_ragged_length_is_the_decode_chains():
    # At T=200 the JAX prefill pads time to 256 and returns the state after
    # 56 pad steps (x = 0 but dt = softplus(dt_b) > 0, so h decays). The
    # port keeps the state after the last prompt token, which is what a
    # chain of single JAX decode steps from zero gives.
    jcfg, tcfg = configs()
    jp, tp = both(mixer_params(jcfg, seed=2))
    x = hidden(2, 200, jcfg.d_model, seed=3)
    chain = jax_decode_chain(jp, jcfg, x)
    cache = mamba.alloc_cache(tcfg, 2, CPU)
    mamba.mamba_apply(tp, torch.from_numpy(x), tcfg, cache, mode="prefill")
    assert float(np.abs(cache["h"].numpy() - np.asarray(chain["h"])).max()
                 ) < 1e-5
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(chain["conv"]), rtol=0, atol=1e-5)


def test_decode_steps_match_jax():
    jcfg, tcfg = configs()
    jp, tp = both(mixer_params(jcfg, seed=4))
    x = hidden(2, 28, jcfg.d_model, seed=5)
    _, j_cache = jax_mamba.mamba_apply(jp, jnp.asarray(x[:, :24]), jcfg,
                                       mode="prefill")
    cache = mamba.alloc_cache(tcfg, 2, CPU)
    mamba.mamba_apply(tp, torch.from_numpy(x[:, :24]), tcfg, cache,
                      mode="prefill")
    for t in range(24, 28):
        j_out, j_cache = jax_mamba.mamba_apply(
            jp, jnp.asarray(x[:, t:t + 1]), jcfg, cache=j_cache, mode="decode")
        out = mamba.mamba_apply(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                cache, mode="decode")
        assert float(np.abs(out.numpy() - np.asarray(j_out)).max()) < 1e-4, t
        assert float(np.abs(cache["h"].numpy() - np.asarray(j_cache["h"])
                            ).max()) < 1e-5, t
        np.testing.assert_allclose(cache["conv"].numpy(),
                                   np.asarray(j_cache["conv"]), rtol=0,
                                   atol=1e-5)


def test_cache_specs_match_jax():
    jcfg, tcfg = configs()
    want = jax_mamba.mamba_cache_specs(
        dataclasses.replace(jcfg, dtype="bfloat16"), 3)
    got = mamba.alloc_cache(dataclasses.replace(tcfg, dtype="bfloat16"), 3, CPU)
    for name in ("h", "conv"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not got[name].any()


def test_specs_match_jax():
    jcfg, tcfg = configs()
    want = jax_mamba.mamba_specs(jcfg)
    got = mamba.mamba_specs(tcfg)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert (got[name].shape, got[name].axes, got[name].init,
                got[name].scale) == (spec.shape, spec.axes, spec.init,
                                     spec.scale), name
        assert (got[name].dtype is None) == (spec.dtype is None), name
