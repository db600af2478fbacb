"""Training jamba (mamba, attention and MoE layers) in the port against the
JAX package.

The jamba smoke preset (one pattern group of 8 layers: 7 mamba, 1
attention, 4 MoE; d_state 4, d_inner 128) in f32, weights drawn by the
port's seeded init and carried into the JAX tree, batches made with numpy
from a seed, with the harness of ``tests/test_torch_train_moe_xlstm.py``.
The port's train step is held to ``jax.value_and_grad`` of the JAX
``loss_fn`` per gradient, max|err| / max|ref| below 1e-4, also with a
capacity factor of 0.5 so that experts overflow; its losses over three
AdamW steps to the jitted JAX step, rtol 1e-4. On the CPU the mamba
layers' scan and its gradient take the plain version (autograd through
``kernels/mamba_scan/ref.py``); the JAX package differentiates its jnp
chunked scan. Under full remat the gradients equal those of
``remat="none"``.
"""
import math

import pytest
import torch

from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.launch import train
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step
from test_torch_train_gemma3 import (NO_UPDATE, batch_np, check_gradients,
                                     check_three_steps, torch_batch)
from test_torch_train_moe_xlstm import dropped_frac, models

ARCH = "jamba-v0.1-52b"
CPU = torch.device("cpu")


def test_jamba_builds_trainable_with_every_mixer():
    jcfg, _, tcfg, model = models(ARCH)
    assert [s.mixer for s in tcfg.pattern] == ["mamba"] * 4 + ["attn"] + [
        "mamba"] * 3
    assert tcfg.n_layers == 8 and tcfg.mamba.d_state == 4
    assert model.trainable and model.can_train
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    assert model.layers[0].mixer.A_log.requires_grad
    with pytest.raises(ValueError, match="trainable=True"):
        Model(tcfg, CPU)(torch.zeros(1, 8, dtype=torch.long), mode="train")


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_jamba_gradients_match_jax(capacity_factor):
    jcfg, params, tcfg, model = models(ARCH, capacity_factor)
    batch = batch_np(2, 40, seed=21)
    if capacity_factor == 0.5:
        assert dropped_frac(model, batch) > 0
    metrics = check_gradients(jcfg, params, tcfg, model, batch)
    assert float(metrics["moe_aux"]) > 0
    assert float(metrics["moe_load_balance"]) > 0
    for l in (0, 7):
        mixer = model.layers[l].mixer
        for name in ("A_log", "D", "dt_b", "x_proj", "conv_w"):
            assert float(getattr(mixer, name).grad.abs().max()) > 0, (l, name)


def test_jamba_losses_over_three_steps_match_jax():
    check_three_steps(*models(ARCH), B=2, T=40)


def test_jamba_full_remat_equals_no_remat():
    grads = []
    batch = torch_batch(batch_np(2, 36, seed=4))
    for remat in ("full", "none"):
        _, _, tcfg, model = models(ARCH, remat=remat)
        make_train_step(tcfg, NO_UPDATE)(
            model, adamw.init_state(dict(model.named_parameters())), batch)
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.allclose(g, grads[1][name], rtol=1e-5, atol=1e-7), name


def test_jamba_train_command_on_the_cpu():
    before = (selective_scan.launches, selective_scan.bwd_launches)
    losses, stats = train.main(["--arch", ARCH, "--device", "cpu",
                                "--steps", "2", "--batch", "2", "--seq",
                                "48"])
    assert stats["layers"] == 8 and len(losses) == 2
    assert all(math.isfinite(x) for x in losses)
    assert all(x > 0 for x in stats["moe_aux"] + stats["moe_load_balance"])
    assert stats["launches"] == [dict.fromkeys(
        ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv", "selective_scan", "selective_scan_bwd"),
        0)] * 2
    assert (selective_scan.launches, selective_scan.bwd_launches) == before
