"""Sliding-window attention and head dim 256 in the port against the JAX
package, on gemma3-12b's smoke preset (5 local : 1 global layers, qk-norm,
gelu_tanh) with every local layer's window cut to 8 in both packages.

Weights come from the JAX ``init_params`` and are carried across with
``params_from_jax``; prompts are made with numpy from a seed. The JAX side
runs as ``src/repro/launch/serve.py`` runs it: prefill, then its ``grow``
of the caches, then one decode step a position. Bounds are those of
``tests/test_models.py`` (f32): prefill logits 1e-4, decode logits 1e-3.
The port keeps a windowed layer's cache at min(P + G, window) slots where
the JAX serve loop grows a short prompt's cache to P + G: the slot order
differs, the attended positions and so the logits do not.

The forward kernel's plain version at head dim 256 is held to the Pallas
kernel in interpret mode, as ``tests/test_torch_flash_attention.py`` does at
the smaller head dims (f32 2e-5, bf16 2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.models import model as JM
from repro.train.step import make_decode_step as jax_decode_step
from repro.train.step import make_prefill_step as jax_prefill_step
from repro_torch.configs import archs as torch_archs
from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention import kernel as cuda_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.train.step import make_decode_step, make_prefill_step

CPU = torch.device("cpu")
WINDOW = 8


def windowed(cfg, window=WINDOW):
    """``cfg`` with every local layer's window replaced by ``window``."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=window if s.window else None)
        for s in cfg.pattern))


def models(arch="gemma3-12b"):
    jcfg = windowed(dataclasses.replace(
        jax_archs.get_config(arch, "smoke"), dtype="float32"))
    tcfg = windowed(dataclasses.replace(
        torch_archs.get_config(arch, "smoke"), dtype="float32"))
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = Model(tcfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, CPU))
    return jcfg, params, tcfg, model


def prompts(B, T, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T),
                                                dtype=np.int32)


def grow(caches, P, total):
    """``src/repro/launch/serve.py``'s cache growth from P to ``total``
    slots (a windowed cache of ``window`` < P slots is left as it is)."""
    def g(path, arr):
        nm = path[-1].key
        if nm in ("k", "v") and arr.ndim == 5 and arr.shape[2] == P:
            pad = jnp.zeros((arr.shape[0], arr.shape[1], total - P)
                            + arr.shape[3:], arr.dtype)
            return jnp.concatenate([arr, pad], axis=2)
        if nm == "pos" and arr.ndim == 2 and arr.shape[1] == P:
            return jnp.concatenate(
                [arr, jnp.full((arr.shape[0], total - P), -1, jnp.int32)], 1)
        return arr

    return jax.tree_util.tree_map_with_path(g, caches)


def jax_serve(jcfg, params, toks, G):
    """The JAX serve loop: (logits of the prefill and of every decode step,
    greedy tokens (B, G + 1))."""
    B, P = toks.shape
    logits, caches = jax_prefill_step(jcfg)(params,
                                            {"tokens": jnp.asarray(toks)})
    caches = grow(caches, P, P + G)
    token = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
    all_logits, tokens = [np.asarray(logits)], [token]
    for t in range(P, P + G):
        logits, nxt, caches = jax_decode_step(jcfg)(
            params, caches, {"tokens": token}, jnp.int32(t))
        token = nxt[:, 0][:, None]
        all_logits.append(np.asarray(logits))
        tokens.append(token)
    return all_logits, np.asarray(jnp.concatenate(tokens, axis=1))


def test_gemma3_smoke_has_windowed_and_global_layers():
    _, _, tcfg, model = models()
    assert [s.window for s in tcfg.pattern] == [WINDOW] * 5 + [None]
    assert tcfg.qk_norm and tcfg.act == "gelu_tanh"
    assert "q_norm" in dict(model.layers[0].mixer.named_parameters())


# P = 24: the prompt is three windows long (windowed prefill fills the
# ring); P = 6: the ring wraps during decode (6 < 8 < 6 + 6)
@pytest.mark.parametrize("P,G", [(24, 6), (6, 6)])
def test_prefill_and_decode_logits_match_jax_serve_loop(P, G):
    jcfg, params, tcfg, model = models()
    toks = prompts(2, P, tcfg.vocab_size, seed=P)
    want_logits, _ = jax_serve(jcfg, params, toks, G)
    tt = torch.from_numpy(toks).long()
    caches = model.alloc_cache(2, P + G)
    with torch.no_grad():
        logits = make_prefill_step(tcfg)(model, {"tokens": tt}, caches)
        assert float(np.abs(logits.numpy() - want_logits[0]).max()) < 1e-4
        token = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
        for i, t in enumerate(range(P, P + G)):
            logits, nxt = make_decode_step(tcfg)(model, caches,
                                                 {"tokens": token}, t)
            err = float(np.abs(logits.numpy() - want_logits[i + 1]).max())
            assert err < 1e-3, (t, err)
            token = nxt[:, :1]


@pytest.mark.parametrize("P,G", [(24, 6), (6, 6), (3, 2)])
def test_greedy_tokens_match_jax_serve_loop(P, G):
    jcfg, params, tcfg, model = models()
    toks = prompts(2, P, tcfg.vocab_size, seed=100 + P)
    _, want = jax_serve(jcfg, params, toks, G)
    got, stats = serve.generate(model, torch.from_numpy(toks).long(), G)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["logits_finite"] and not stats["decode_captured"]


@pytest.mark.parametrize("P,G", [(24, 6), (6, 6), (5, 2)])
def test_windowed_cache_is_a_ring_of_min_p_g_window_slots(P, G):
    _, _, tcfg, model = models()
    toks = torch.from_numpy(prompts(1, P, tcfg.vocab_size)).long()
    caches = model.alloc_cache(1, P + G)
    S = min(P + G, WINDOW)
    assert [c["k"].shape[1] for c in caches] == [S] * 5 + [P + G]
    with torch.no_grad():
        logits = make_prefill_step(tcfg)(model, {"tokens": toks}, caches)
        token = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
        for t in range(P, P + G):
            token = make_decode_step(tcfg)(model, caches, {"tokens": token},
                                           t)[1][:, :1]
    # slot p % S holds position p for the last S positions; the global
    # layer holds every position at its own slot
    want = [-1] * S
    for p in range(max(0, P + G - S), P + G):
        want[p % S] = p
    for layer in caches[:5]:
        assert layer["pos"].tolist() == want
    assert caches[5]["pos"].tolist() == list(range(P + G))


def test_windowed_prefill_keys_sit_at_their_ring_slots():
    # the ring's k at slot p % S is the prefill's key of position p: the
    # same key the global layer keeps at slot p, when both layers see the
    # same input (one layer each, the same weights)
    _, _, tcfg, _ = models()
    one = dataclasses.replace(tcfg, n_layers=1, pattern=tcfg.pattern[:1])
    glob = dataclasses.replace(one, pattern=(dataclasses.replace(
        one.pattern[0], window=None),))
    a, b = Model(one, CPU).init_weights(0), Model(glob, CPU).init_weights(0)
    toks = torch.from_numpy(prompts(2, 21, tcfg.vocab_size)).long()
    ca, cb = a.alloc_cache(2, 21), b.alloc_cache(2, 21)
    with torch.no_grad():
        make_prefill_step(one)(a, {"tokens": toks}, ca)
        make_prefill_step(glob)(b, {"tokens": toks}, cb)
    for p in range(21 - WINDOW, 21):
        assert torch.equal(ca[0]["k"][:, p % WINDOW], cb[0]["k"][:, p])
        assert torch.equal(ca[0]["v"][:, p % WINDOW], cb[0]["v"][:, p])


def _inputs(shapes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("window", [None, 32, 100])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_head_dim_256_matches_pallas_kernel(window, dtype, tol):
    B, T, H, D = 1, 128, 2, 256
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, T, H, D)] * 3, dtype,
                                         seed=7 + (window or 0))
    bhtd = lambda x: x.transpose(0, 2, 1, 3)
    j_out, j_lse = flash_attention_fwd(bhtd(jq), bhtd(jk), bhtd(jv),
                                       window=window, block_q=64, block_k=64,
                                       interpret=True)
    out, lse = flash_attention(tq, tk, tv, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert float(np.abs(_np(out) - _np(bhtd(j_out))).max()) < tol
    assert float(np.abs(_np(lse) - _np(j_lse)).max()) < tol


def test_all_three_kernel_checks_take_head_dim_256():
    assert all(256 in cuda_kernel.HEAD_DIMS[k] for k in ("fwd", "dq", "dkv"))
    x = torch.zeros(1, 64, 2, 256)
    lse = torch.zeros(1, 2, 64)
    # each passes the head-dim check and stops at the device check
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_kernel.flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_kernel.flash_bwd_dq(x, x, x, x, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_kernel.flash_bwd_dkv(x, x, x, x, lse, lse)