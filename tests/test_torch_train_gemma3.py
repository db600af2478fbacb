"""Training gemma3-12b in the port against the JAX package.

The smoke preset (5 windowed : 1 global layers, qk-norm, gelu_tanh) with
every window cut to 8 in both packages, as ``tests/test_torch_window.py``
does, in f32, at its own head dim of 16 and at gemma3's head dim of 256 with
narrow widths (2 query heads, 1 kv head). Weights are drawn by the port's
seeded init and carried into the JAX parameter tree
(:func:`jax_params_from_port`): the JAX ``init_params`` seeds each tensor
with Python's salted ``hash``, so its weights change from process to
process, and its ``scaled`` init divides by the number of groups, not the
fan-in (ROADMAP, reference quirks). Batches are made with numpy from a
seed. The port's train step is held to
``jax.value_and_grad`` of the JAX ``loss_fn`` (``make_train_step``) per
gradient, max|err| / max|ref| below 1e-4 (``tests/test_torch_train.py``),
and its losses over three AdamW steps to the jitted JAX step, rtol 1e-4.
On the CPU attention takes the flash kernels' plain versions; T = 32 is
the JAX naive path and T = 64 its blockwise one (``attn_block`` 32).
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
from repro.train.losses import chunked_ce_loss as jax_ce
from repro.train.step import make_train_step as jax_train_step
from repro_torch.configs import archs as torch_archs
from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import train
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.losses import IGNORE
from repro_torch.train.step import make_train_step

CPU = torch.device("cpu")
WINDOW = 8
NO_UPDATE = adamw.AdamWConfig(lr=0.0, weight_decay=0.0, clip_norm=None)
# head dim 256 at narrow widths: 2 query heads sharing 1 kv head
D256 = dict(d_head=256, n_heads=2, n_kv_heads=1)


def windowed(cfg):
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=WINDOW if s.window else None)
        for s in cfg.pattern))


def jax_params_from_port(model, jcfg):
    """The JAX parameter tree of ``model``'s weights: the inverse of
    ``params_from_jax``, each ``pos{i}`` leaf stacked over the groups.
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
    params = {k: jnp.asarray(state[k])
              for k in ("embed", "final_norm", "lm_head")}
    params.update({f"pos{i}": group(shapes[f"pos{i}"], "", i)
                   for i in range(plen)})
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    return params


def models(arch="gemma3-12b", **changes):
    """(JAX config, JAX params, port config, port model with the same
    weights, seed 0), f32, windows cut to 8."""
    changes = dict(dtype="float32", **changes)
    jcfg = windowed(dataclasses.replace(jax_archs.get_config(arch, "smoke"),
                                        **changes))
    tcfg = windowed(dataclasses.replace(
        torch_archs.get_config(arch, "smoke"), **changes))
    model = Model(tcfg, CPU, trainable=True).init_weights(0)
    return jcfg, jax_params_from_port(model, jcfg), tcfg, model


def batch_np(B, T, seed, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, T + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = IGNORE
    return {"tokens": toks[:, :-1], "labels": labels}


def torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def jax_loss_and_grads(params, batch, cfg):
    """``jax.value_and_grad`` of the JAX ``loss_fn`` (``make_train_step``):
    ((loss, metrics with moe_aux and moe_load_balance), grads)."""
    def loss_fn(p, b):
        hidden, aux, _ = JM.forward(p, b, cfg, mode="train")
        lm_head = p["lm_head"].astype(jnp.dtype(cfg.dtype))
        loss, metrics = jax_ce(hidden, lm_head, b["labels"], cfg)
        return loss + aux[0], dict(metrics, moe_aux=aux[0],
                                   moe_load_balance=aux[1])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_gradients(jcfg, params, tcfg, model, batch):
    """One port train step against the JAX loss and gradients; returns the
    port's metrics."""
    (jl, jm), jg = jax_loss_and_grads(params, batch, jcfg)
    metrics = make_train_step(tcfg, NO_UPDATE)(
        model, adamw.init_state(dict(model.named_parameters())),
        torch_batch(batch))
    assert abs(float(metrics["loss"]) - float(jl)) < 1e-5 * abs(float(jl))
    for k in ("ce", "z_loss", "moe_aux", "moe_load_balance"):
        assert abs(float(metrics[k]) - float(jm[k])) < 1e-5 * max(
            1, abs(float(jm[k]))), (k, float(metrics[k]), float(jm[k]))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg, CPU)
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(want)
    for name, p in names.items():
        assert p.grad.dtype == torch.float32, name
        assert rel(p.grad, want[name]) < 1e-4, (name, rel(p.grad, want[name]))
    return metrics


def check_three_steps(jcfg, params, tcfg, model, B, T):
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jax_train_step(jcfg, jax_adamw.AdamWConfig(**ocfg)))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**ocfg))
    jstate = jax_adamw.init_state(params)
    tstate = adamw.init_state(dict(model.named_parameters()))
    for step in range(3):
        batch = batch_np(B, T, seed=100 + step)
        params, jstate, jm = jstep(params, jstate,
                                   jax.tree.map(jnp.asarray, batch))
        tm = tstep(model, tstate, torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)


def test_gemma3_trains_with_windowed_and_global_layers():
    _, _, tcfg, model = models()
    assert model.can_train and model.trainable
    assert [s.window for s in tcfg.pattern] == [WINDOW] * 5 + [None]
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())


@pytest.mark.parametrize("T", [32, 64])
def test_gemma3_gradients_match_jax(T):
    metrics = check_gradients(*models(), batch_np(2, T, seed=T))
    assert float(metrics["moe_aux"]) == 0


def test_gemma3_gradients_match_jax_at_head_dim_256():
    jcfg, params, tcfg, model = models(**D256)
    assert tcfg.head_dim == 256
    assert model.layers[5].mixer.wq.shape == (tcfg.d_model, 2 * 256)
    check_gradients(jcfg, params, tcfg, model, batch_np(2, 40, seed=5))


def test_gemma3_losses_over_three_steps_match_jax():
    check_three_steps(*models(), B=4, T=32)


def test_gemma3_losses_over_three_steps_match_jax_at_head_dim_256():
    check_three_steps(*models(**D256), B=2, T=24)


def test_gemma3_cpu_training_counts_no_kernel_launch():
    before = dict(flash_attention.launches_by_shape)
    losses, stats = train.main([
        "--device", "cpu", "--arch", "gemma3-12b", "--preset", "smoke",
        "--steps", "2", "--batch", "2", "--seq", "32", "--layers", "7"])
    assert stats["layers"] == 6                 # whole pattern groups
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert stats["launches_by_shape"] == [{}, {}]
    assert stats["moe_aux"] == [0.0, 0.0]
    assert flash_attention.launches_by_shape == before
