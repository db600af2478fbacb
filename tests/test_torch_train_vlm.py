"""Training and serving llama-3.2-vision-11b (gated cross-attention over
encoder embeddings) in the port against the JAX package.

The smoke preset (5 layers: 4 self-attention, then one with a gated
cross-attention sublayer; ``encoder_len`` 32, ``attn_block`` 32) in f32.
Weights are drawn by the port's seeded init and carried into the JAX tree
(:func:`jax_params`, as ``tests/test_torch_train_gemma3.py`` does), every
cross-attention gate set to 0.5 first: the init gate is 0, and tanh(0) = 0
would zero the sublayer's output and every gradient into it, so that a
parity test on it proves nothing (the tests assert a non-zero output and
non-zero gradients). Batches are made with numpy from a seed.

Held to the JAX package: the gradients of one train step against
``jax.value_and_grad`` of the JAX ``loss_fn``, max|err| / max|ref| below
1e-4, at T 24 (JAX's naive cross-attention) and T 40 against S 32 keys
(its blockwise one); the losses over three AdamW steps against the jitted
JAX step, rtol 1e-4; the prefill logits (1e-4) and the decode logits of
the following steps (1e-3) against ``make_prefill_step`` and
``make_decode_step`` (the port of ``tests/test_models.py``'s
``test_decode_matches_forward``); and ``remat="dots"`` against
``remat="full"`` and JAX's ``"dots"``. On the CPU attention takes the flash
kernels' plain versions (non-causal, T queries against S keys).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.train.step import make_decode_step as jax_decode_step
from repro.train.step import make_prefill_step as jax_prefill_step
from repro.train.step import make_train_step as jax_train_step
from repro_torch.configs import archs as torch_archs
from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import train
from repro_torch.launch.train import to_device
from repro_torch.models import attention
from repro_torch.models.common import cast_params
from repro_torch.models.model import Model, param_count
from repro_torch.optim import adamw
from repro_torch.train.losses import IGNORE
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    make_train_step)
from test_torch_train_gemma3 import NO_UPDATE, jax_loss_and_grads, rel

CPU = torch.device("cpu")
ARCH = "llama-3.2-vision-11b"
GATE = 0.5


def jax_params(model, jcfg):
    """The JAX parameter tree of ``model``'s weights (the inverse of
    ``params_from_jax``): each ``pos{i}`` leaf stacked over the groups,
    the top-level leaves (``embed`` only for a token model) as they are.
    Every leaf is a copy: ``jnp.asarray`` of an aligned numpy view would
    share memory with the port's weights, which its optimizer updates in
    place."""
    state = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    plen = len(jcfg.pattern)

    def group(tree, prefix, i):
        return {k: group(v, f"{prefix}{k}.", i) if isinstance(v, dict)
                else jnp.asarray(np.stack(
                    [state[f"layers.{g * plen + i}.{prefix}{k}"]
                     for g in range(jcfg.n_groups)]))
                for k, v in tree.items()}

    shapes = JM.param_shapes(jcfg)
    params = {k: (group(v, "", int(k[3:])) if k.startswith("pos")
                  else jnp.asarray(state[k])) for k, v in shapes.items()}
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    return params


def set_gates(model, value=GATE):
    """Every cross-attention gate to ``value``; returns how many."""
    gates = [p for n, p in model.named_parameters() if n.endswith(".gate")]
    with torch.no_grad():
        for p in gates:
            p.fill_(value)
    return len(gates)


def models(arch=ARCH, **changes):
    """(JAX config, JAX params, port config, port model with the same
    weights, seed 0), f32, the gates at 0.5."""
    changes = dict(dtype="float32", **changes)
    jcfg, tcfg = (dataclasses.replace(a.get_config(arch, "smoke"), **changes)
                  for a in (jax_archs, torch_archs))
    model = Model(tcfg, CPU, trainable=True).init_weights(0)
    set_gates(model)
    return jcfg, jax_params(model, jcfg), tcfg, model


def batch_np(cfg, B, T, seed, labels=True):
    """A batch as the JAX package takes it, from numpy: tokens (or frames
    (B, T, E) of a ``frames`` model), encoder embeddings (B, N, E) of a vlm
    model, labels (B, T) (or (B, T, n_codebooks)) with a few ignored."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "frames":
        out["frames"] = rng.standard_normal((B, T, cfg.d_model),
                                            dtype=np.float32)
        shape = (B, T, cfg.n_codebooks)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, T),
                                     dtype=np.int32)
        shape = (B, T)
    if cfg.input_mode == "tokens+image":
        out["encoder_embeddings"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model), dtype=np.float32)
    if labels:
        lab = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
        lab[0, :3] = IGNORE
        out["labels"] = lab
    return out


def check_gradients(jcfg, params, tcfg, model, batch):
    """One port train step against the JAX loss, metrics and gradients;
    returns the port's gradients by name."""
    (jl, jm), jg = jax_loss_and_grads(params, batch, jcfg)
    metrics = make_train_step(tcfg, NO_UPDATE)(
        model, adamw.init_state(dict(model.named_parameters())),
        to_device(batch, CPU))
    assert abs(float(metrics["loss"]) - float(jl)) < 1e-5 * abs(float(jl))
    for k in ("ce", "z_loss"):
        assert abs(float(metrics[k]) - float(jm[k])) < 1e-5 * max(
            1, abs(float(jm[k]))), (k, float(metrics[k]), float(jm[k]))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg, CPU)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        assert rel(g, want[name]) < 1e-4, (name, rel(g, want[name]))
    return grads


def check_three_steps(jcfg, params, tcfg, model, B, T):
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jax_train_step(jcfg, jax_adamw.AdamWConfig(**ocfg)))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**ocfg))
    jstate = jax_adamw.init_state(params)
    tstate = adamw.init_state(dict(model.named_parameters()))
    for step in range(3):
        batch = batch_np(tcfg, B, T, seed=100 + step)
        params, jstate, jm = jstep(params, jstate,
                                   jax.tree.map(jnp.asarray, batch))
        tm = tstep(model, tstate, to_device(batch, CPU))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)


def check_prefill_and_decode(jcfg, params, tcfg, model, B=2, T=24, Tp=20):
    """Prefill the first ``Tp`` positions, then decode the rest one by one,
    in both packages: the prefill logits within 1e-4, each decode step's
    within 1e-3 (``tests/test_models.py``)."""
    batch = batch_np(tcfg, B, T, seed=7, labels=False)
    seq = "frames" if "frames" in batch else "tokens"
    pb = {k: (v[:, :Tp] if k == seq else v) for k, v in batch.items()}
    jlogits, jcaches = jax_prefill_step(jcfg)(
        params, jax.tree.map(jnp.asarray, pb))

    # grow the JAX full-attention caches from Tp to T slots
    def grow(path, arr):
        nm = path[-1].key
        if nm in ("k", "v") and arr.ndim == 5 and arr.shape[2] == Tp:
            pad = jnp.zeros(arr.shape[:2] + (T - Tp,) + arr.shape[3:],
                            arr.dtype)
            return jnp.concatenate([arr, pad], axis=2)
        if nm == "pos" and arr.ndim == 2 and arr.shape[1] == Tp:
            return jnp.concatenate(
                [arr, jnp.full((arr.shape[0], T - Tp), -1, jnp.int32)], 1)
        return arr

    jcaches = jax.tree_util.tree_map_with_path(grow, jcaches)
    caches = model.alloc_cache(B, T)
    with torch.no_grad():
        logits = make_prefill_step(tcfg)(model, to_device(pb, CPU), caches)
    assert logits.shape == (B, tcfg.n_codebooks, tcfg.padded_vocab_size)
    assert float((logits - torch.tensor(np.asarray(jlogits))
                  ).abs().max()) < 1e-4
    jdecode = jax.jit(jax_decode_step(jcfg))
    for t in range(Tp, T):
        db = {seq: batch[seq][:, t:t + 1]}
        jl, _, jcaches = jdecode(params, jcaches,
                                 jax.tree.map(jnp.asarray, db), jnp.int32(t))
        with torch.no_grad():
            tl, tok = make_decode_step(tcfg)(model, caches,
                                             to_device(db, CPU), t)
        err = float((tl - torch.tensor(np.asarray(jl))).abs().max())
        assert err < 1e-3, (t, err)
        assert tok.shape == (B, tcfg.n_codebooks)
    return caches


def cross_layers(cfg):
    return [l for l in range(cfg.n_layers)
            if cfg.pattern[l % len(cfg.pattern)].cross_attn]


def test_vlm_builds_with_a_gated_cross_attention_layer():
    _, _, tcfg, model = models()
    assert cross_layers(tcfg) == [4]
    cross = model.layers[4].cross
    assert cross.gate.shape == () and float(cross.gate.detach()) == GATE
    assert cross.wk.shape == (tcfg.d_model, tcfg.n_kv_heads * tcfg.head_dim)
    assert hasattr(model.layers[4], "norm_cross")
    assert not hasattr(model.layers[0], "cross")
    # the init gate is 0, so the sublayer starts as the identity
    fresh = Model(tcfg, CPU, trainable=True).init_weights(0)
    assert float(fresh.layers[4].cross.gate) == 0.0


@pytest.mark.parametrize("arch", [ARCH, "musicgen-large"])
def test_param_count_equals_the_built_model(arch):
    for preset in ("smoke", "full"):
        cfg = torch_archs.get_config(arch, preset)
        if preset == "full":
            # the full model is not built: count on the meta device
            with torch.device("meta"):
                model = Model(cfg, torch.device("meta"))
        else:
            model = Model(cfg, CPU)
        assert sum(p.numel() for p in model.parameters()) == param_count(cfg)
        assert param_count(cfg) == JM.param_count(
            jax_archs.get_config(arch, preset))


def test_cross_attention_output_is_not_zero():
    _, _, tcfg, model = models()
    b = to_device(batch_np(tcfg, 2, 24, seed=3), CPU)
    h = torch.randn(2, 24, tcfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = attention.cross_attn_apply(
            cast_params(model.layers[4].cross, torch.float32), h,
            b["encoder_embeddings"], tcfg, mode="train")
    assert out.shape == h.shape and float(out.norm()) > 0


@pytest.mark.parametrize("T", [24, 40])
def test_vlm_gradients_match_jax(T):
    jcfg, params, tcfg, model = models()
    grads = check_gradients(jcfg, params, tcfg, model,
                            batch_np(tcfg, 2, T, seed=T))
    for name in ("wq", "wk", "wv", "wo", "gate"):
        assert float(grads[f"layers.4.cross.{name}"].abs().max()) > 0, name


def test_vlm_losses_over_three_steps_match_jax():
    check_three_steps(*models(), B=2, T=40)


def test_vlm_prefill_and_decode_match_jax():
    jcfg, params, tcfg, model = models()
    caches = check_prefill_and_decode(jcfg, params, tcfg, model)
    kv = caches[4]["cross_kv"]
    assert kv["k"].shape == (2, tcfg.encoder_len, tcfg.n_kv_heads,
                             tcfg.head_dim)
    assert float(kv["k"].abs().max()) > 0
    assert "cross_kv" not in caches[0]


def test_vlm_dots_remat_matches_full_and_jax():
    batch = batch_np(torch_archs.get_config(ARCH, "smoke"), 2, 40, seed=11)
    jcfg, params, tcfg, model = models(remat="dots")
    dots = check_gradients(jcfg, params, tcfg, model, batch)
    _, _, _, full = models(remat="full")
    make_train_step(tcfg, NO_UPDATE)(
        full, adamw.init_state(dict(full.named_parameters())),
        to_device(batch, CPU))
    for name, p in full.named_parameters():
        assert torch.allclose(dots[name], p.grad, rtol=1e-5, atol=1e-7), name


def test_frames_model_params_round_trip_through_jax_tree():
    for arch in (ARCH, "musicgen-large"):
        jcfg, params, tcfg, model = models(arch)
        state = params_from_jax(jax.tree.map(np.asarray, params), tcfg, CPU)
        assert sorted(state) == sorted(model.state_dict())
        assert ("embed" in state) == (tcfg.input_mode != "frames")
        for name, t in model.state_dict().items():
            assert torch.equal(state[name], t), name


def test_vlm_cpu_training_counts_no_kernel_launch():
    before = dict(flash_attention.launches_by_shape)
    losses, stats = train.main([
        "--device", "cpu", "--arch", ARCH, "--preset", "smoke",
        "--steps", "2", "--batch", "2", "--seq", "32", "--layers", "7"])
    assert stats["layers"] == 5                 # whole pattern groups
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert stats["launches_by_shape"] == [{}, {}]
    assert flash_attention.launches_by_shape == before
