"""The port's xLSTM mixers (mLSTM, sLSTM) against the JAX package on
xlstm-125m's smoke preset (chunk 16), f32.

Mixer weights come from the JAX ``init_from_specs``, model weights from
``init_params`` carried across with ``params_from_jax``; inputs are made
with numpy from a seed. Prefill runs at T = 40 (not a multiple of the
chunk: the JAX package pads the last chunk) and at T = 16 (one chunk).
Bounds: mixer outputs and states 1e-5 (f32 sums of a few hundred terms of
order 1), model logits 1e-4 prefill and 1e-3 decode as in
``tests/test_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import common as jax_common
from repro.models import model as JM
from repro.models import xlstm as jax_xlstm
from repro.train.step import make_decode_step as jax_decode_step
from repro.train.step import make_prefill_step as jax_prefill_step
from repro_torch.configs import archs as torch_archs
from repro_torch.interop import params_from_jax, tensor_from_numpy
from repro_torch.launch import serve
from repro_torch.models import model as torch_model
from repro_torch.models import xlstm
from repro_torch.models.common import SpecModule
from repro_torch.models.model import Model
from repro_torch.train.step import make_decode_step, make_prefill_step

CPU = torch.device("cpu")
TOL = 1e-5
MIXERS = {
    "mlstm": (jax_xlstm.mlstm_specs, jax_xlstm.mlstm_apply,
              xlstm.mlstm_specs, xlstm.mlstm_apply, xlstm.mlstm_alloc_cache),
    "slstm": (jax_xlstm.slstm_specs, jax_xlstm.slstm_apply,
              xlstm.slstm_specs, xlstm.slstm_apply, xlstm.slstm_alloc_cache),
}


def configs():
    j = dataclasses.replace(jax_archs.get_config("xlstm-125m", "smoke"),
                            dtype="float32")
    t = dataclasses.replace(torch_archs.get_config("xlstm-125m", "smoke"),
                            dtype="float32")
    return j, t


def mixer(name, seed=0):
    """(JAX params, port module) of one mixer with the same weights. The
    zero-initialized biases and norms get random values, so that they
    count."""
    jcfg, tcfg = configs()
    jspecs, _, tspecs, _, _ = MIXERS[name]
    params = jax_common.init_from_specs(jax.random.PRNGKey(seed),
                                        jspecs(jcfg), jnp.float32)
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v) if v.ndim > 1 else
                  np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
                      np.float32))
              for k, v in params.items()}
    mod = SpecModule(tspecs(tcfg), torch.float32, CPU)
    mod.load_state_dict({k: tensor_from_numpy(v, CPU)
                         for k, v in params.items()})
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, tcfg, mod


def x_of(B, T, E, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, T, E)).astype(np.float32)


def assert_close(got, want, tol=TOL):
    err = float(np.abs(got.detach().numpy() - np.asarray(want)).max())
    assert err < tol, err


@pytest.mark.parametrize("T", [40, 16])
@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_prefill_matches_jax(name, T):
    jcfg, params, tcfg, mod = mixer(name)
    _, j_apply, _, t_apply, alloc = MIXERS[name]
    x = x_of(2, T, tcfg.d_model)
    want, j_cache = j_apply(params, jnp.asarray(x), jcfg, mode="prefill")
    cache = alloc(tcfg, 2, CPU)
    with torch.no_grad():
        got = t_apply(mod, torch.from_numpy(x), tcfg, cache, mode="prefill")
    assert_close(got, want)
    assert set(cache) == set(j_cache)
    for k in cache:
        assert cache[k].shape == j_cache[k].shape, k
        assert_close(cache[k], j_cache[k])


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_train_mode_matches_prefill_output(name):
    _, _, tcfg, mod = mixer(name, seed=3)
    _, _, _, t_apply, alloc = MIXERS[name]
    x = torch.from_numpy(x_of(2, 20, tcfg.d_model, seed=4))
    with torch.no_grad():
        a = t_apply(mod, x, tcfg, alloc(tcfg, 2, CPU), mode="prefill")
        b = t_apply(mod, x, tcfg, None, mode="train")
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_decode_chain_matches_jax(name):
    jcfg, params, tcfg, mod = mixer(name, seed=1)
    _, j_apply, _, t_apply, alloc = MIXERS[name]
    P, G = 21, 5
    x = x_of(2, P + G, tcfg.d_model, seed=2)
    _, j_cache = j_apply(params, jnp.asarray(x[:, :P]), jcfg, mode="prefill")
    cache = alloc(tcfg, 2, CPU)
    with torch.no_grad():
        t_apply(mod, torch.from_numpy(x[:, :P]), tcfg, cache, mode="prefill")
        for t in range(P, P + G):
            want, j_cache = j_apply(params, jnp.asarray(x[:, t:t + 1]), jcfg,
                                    cache=j_cache, mode="decode")
            got = t_apply(mod, torch.from_numpy(x[:, t:t + 1]), tcfg, cache,
                          mode="decode")
            assert got.shape == (2, 1, tcfg.d_model)
            assert_close(got, want)
    for k in cache:
        assert_close(cache[k], j_cache[k])


def test_mlstm_state_after_padded_prefill_is_the_last_tokens():
    # T = 40 pads the last chunk by 8 steps; they add and forget nothing, so
    # the prefill state equals that of prefill over 32 tokens then 8 decodes
    _, _, tcfg, mod = mixer("mlstm", seed=5)
    x = torch.from_numpy(x_of(1, 40, tcfg.d_model, seed=6))
    whole, part = (xlstm.mlstm_alloc_cache(tcfg, 1, CPU) for _ in range(2))
    with torch.no_grad():
        xlstm.mlstm_apply(mod, x, tcfg, whole, mode="prefill")
        xlstm.mlstm_apply(mod, x[:, :32], tcfg, part, mode="prefill")
        for t in range(32, 40):
            xlstm.mlstm_apply(mod, x[:, t:t + 1], tcfg, part, mode="decode")
    for k in ("C", "n", "m", "conv"):
        assert float((whole[k] - part[k]).abs().max()) < TOL, k


def jax_model():
    jcfg, tcfg = configs()
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = Model(tcfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, CPU))
    return jcfg, params, tcfg, model


def test_model_logits_and_greedy_tokens_match_jax_serve_loop():
    jcfg, params, tcfg, model = jax_model()
    B, P, G = 2, 40, 6
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (B, P),
                                             dtype=np.int32)
    logits, caches = jax_prefill_step(jcfg)(params,
                                            {"tokens": jnp.asarray(toks)})
    token = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
    want_logits, want = [np.asarray(logits)], [token]
    for t in range(P, P + G):
        logits, nxt, caches = jax_decode_step(jcfg)(
            params, caches, {"tokens": token}, jnp.int32(t))
        token = nxt[:, 0][:, None]
        want_logits.append(np.asarray(logits))
        want.append(token)
    want = np.asarray(jnp.concatenate(want, axis=1))

    got, stats = serve.generate(model, torch.from_numpy(toks).long(), G)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(np.abs(stats["prefill_logits"].numpy()
                        - want_logits[0]).max()) < 1e-4
    assert float(np.abs(stats["decode_logits"].numpy()
                        - want_logits[-1]).max()) < 1e-3
    assert stats["prefill_kernel_launches"] == {"flash_attention_fwd": 0,
                                                "selective_scan": 0}

    # the step functions, one decode logit set at a time
    caches = model.alloc_cache(B, P + G)
    with torch.no_grad():
        make_prefill_step(tcfg)(model, {"tokens": torch.from_numpy(toks)
                                        .long()}, caches)
        for i, t in enumerate(range(P, P + G)):
            logits, _ = make_decode_step(tcfg)(
                model, caches, {"tokens": got[:, i:i + 1]}, t)
            err = float(np.abs(logits.numpy() - want_logits[i + 1]).max())
            assert err < 1e-3, (t, err)


def test_layers_have_no_ffn_and_counts_match_jax():
    jcfg, tcfg = configs()
    model = Model(tcfg, CPU)
    names = {n for n, _ in model.named_parameters()}
    assert not any(".ffn." in n or "norm_ffn" in n for n in names)
    assert {"layers.0.mixer.w_if", "layers.1.mixer.r_gates"} <= names
    assert model.layers[0].mixer.w_if.dtype == torch.float32
    assert torch_model.param_count(tcfg) == sum(
        p.numel() for p in model.parameters()) == JM.param_count(jcfg)
    full_j = jax_archs.get_config("xlstm-125m", "full")
    full_t = torch_archs.get_config("xlstm-125m", "full")
    assert torch_model.param_count(full_t) == JM.param_count(full_j)

