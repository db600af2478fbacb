"""Training the MoE (granite-moe-3b-a800m, deepseek-moe-16b) and xLSTM
(xlstm-125m) families in the port against the JAX package.

Smoke presets in f32 (the MoE models with 2 layers, so that the aux vector
sums over layers), weights drawn by the port's seeded init and carried into
the JAX tree, batches made with numpy from a seed, as in
``tests/test_torch_train_gemma3.py`` (with the JAX init's per-process
weights, xlstm's three-step grad norms drifted apart by up to 1.2e-3:
three Adam steps, about lr·sign(g) each, amplify f32 rounding through the
sLSTM's exponential gates). The port's train
step is held to ``jax.value_and_grad`` of the JAX ``loss_fn`` per gradient,
max|err| / max|ref| below 1e-4 (``tests/test_torch_train.py``), with the
loss, ``moe_aux`` (the weighted load-balance and router-z losses, which the
loss includes) and ``moe_load_balance`` against JAX's metrics; and its
losses over three AdamW steps to the jitted JAX step, rtol 1e-4. A capacity
factor of 0.5 makes experts overflow, so the gradients pass through the
reference's overflow quirk (a token kept at slot C-1 of an expert that
dropped a choice reads the zero row; ``src/repro_torch/models/moe.py``).
Under full remat the aux vector comes out of each layer's checkpoint, and
the gradients equal those of ``remat="none"``.
"""
import dataclasses

import pytest
import torch

from repro.configs import archs as jax_archs
from repro_torch.configs import archs as torch_archs
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step
from test_torch_train_gemma3 import (NO_UPDATE, batch_np, check_gradients,
                                     check_three_steps, jax_params_from_port,
                                     torch_batch)

CPU = torch.device("cpu")
MOE = ("granite-moe-3b-a800m", "deepseek-moe-16b")


def models(arch, capacity_factor=None, **changes):
    """(JAX config, JAX params, port config, port model with the same
    weights), f32."""
    changes = dict(dtype="float32", **changes)
    out = []
    for archs in (jax_archs, torch_archs):
        cfg = dataclasses.replace(archs.get_config(arch, "smoke"), **changes)
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    jcfg, tcfg = out
    model = Model(tcfg, CPU, trainable=True).init_weights(0)
    return jcfg, jax_params_from_port(model, jcfg), tcfg, model


def dropped_frac(model, batch):
    with torch.no_grad():
        _, aux = model(torch_batch(batch)["tokens"], mode="train")
    return float(aux[3])


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_gradients_and_aux_match_jax(arch, capacity_factor):
    jcfg, params, tcfg, model = models(arch, capacity_factor, n_layers=2)
    batch = batch_np(2, 32, seed=11)
    drops = dropped_frac(model, batch)
    if capacity_factor == 0.5:
        assert drops > 0            # some expert overflows in each layer
    metrics = check_gradients(jcfg, params, tcfg, model, batch)
    assert float(metrics["moe_aux"]) > 0
    assert float(metrics["moe_load_balance"]) > 0
    if tcfg.moe.n_shared:
        assert float(model.layers[0].ffn.shared_wg.grad.abs().max()) > 0
    assert float(model.layers[1].ffn.router.grad.abs().max()) > 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_losses_over_three_steps_match_jax(arch):
    check_three_steps(*models(arch, n_layers=2), B=2, T=32)


@pytest.mark.parametrize("arch", MOE)
def test_aux_through_full_remat_equals_no_remat(arch):
    grads, aux = [], []
    batch = torch_batch(batch_np(2, 24, seed=3))
    for remat in ("full", "none"):
        _, _, tcfg, model = models(arch, 0.5, n_layers=2, remat=remat)
        metrics = make_train_step(tcfg, NO_UPDATE)(
            model, adamw.init_state(dict(model.named_parameters())), batch)
        aux.append([float(metrics[k]) for k in ("moe_aux",
                                                "moe_load_balance")])
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert aux[0] == aux[1] and aux[0][0] > 0
    for name, g in grads[0].items():
        assert torch.allclose(g, grads[1][name], rtol=1e-5, atol=1e-7), name


@pytest.mark.parametrize("T", [16, 40])
def test_xlstm_gradients_match_jax(T):
    jcfg, params, tcfg, model = models("xlstm-125m")
    assert [s.mixer for s in tcfg.pattern] == ["mlstm", "slstm"]
    metrics = check_gradients(jcfg, params, tcfg, model,
                              batch_np(2, T, seed=T))
    assert float(metrics["moe_aux"]) == 0


def test_xlstm_losses_over_three_steps_match_jax():
    check_three_steps(*models("xlstm-125m"), B=2, T=40)
