"""The port's MoE FFN against the JAX package's ``moe_apply``.

Weights and inputs are made with numpy from a seed and go through both
packages in f32. The routing is the same, so only the order of f32 sums
differs: the output (magnitudes up to ~10) is held to 1e-4, the aux stats
to 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import moe as jax_moe
from repro_torch.configs import archs as torch_archs
from repro_torch.models import moe

AUX = ("moe_load_balance", "moe_router_z", "moe_dropped_frac", "moe_aux_loss")


def configs(arch="jamba-v0.1-52b", **moe_changes):
    out = []
    for archs in (jax_archs, torch_archs):
        cfg = archs.get_config(arch, "smoke")
        out.append(dataclasses.replace(
            cfg, dtype="float32",
            moe=dataclasses.replace(cfg.moe, **moe_changes)))
    return out


def ffn_params(cfg, router_scale=0.5, seed=0):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(spec.shape)
                   * (router_scale if name == "router" else 0.2)
                   ).astype(np.float32)
            for name, spec in jax_moe.moe_specs(cfg).items()}


def run_both(arch="jamba-v0.1-52b", B=2, T=64, token_group=4096, seed=0,
             **moe_changes):
    jcfg, tcfg = configs(arch, **moe_changes)
    params = ffn_params(jcfg, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    j_y, j_aux = jax_moe.moe_apply({k: jnp.asarray(v) for k, v in params.items()},
                                   jnp.asarray(x), jcfg, token_group=token_group)
    y, aux = moe.moe_apply({k: torch.from_numpy(v) for k, v in params.items()},
                           torch.from_numpy(x), tcfg, token_group=token_group)
    assert float(np.abs(y.numpy() - np.asarray(j_y)).max()) < 1e-4
    for name in AUX:
        assert abs(float(aux[name]) - float(j_aux[name])) < 1e-5, name
    return y, aux


def test_default_capacity_with_drops_matches_jax():
    # capacity 40 slots an expert for 128 tokens x 2 choices over 8
    # experts: some expert overflows, so some token kept at slot C-1 reads
    # the zero row (the JAX scatter's last write), as in the JAX package
    _, aux = run_both()
    assert float(aux["moe_dropped_frac"]) > 0


def test_capacity_factor_8_drops_nothing():
    _, aux = run_both(capacity_factor=8.0)
    assert float(aux["moe_dropped_frac"]) == 0


@pytest.mark.parametrize("token_group", [48, 100])
def test_padded_token_groups_match_jax(token_group):
    # 128 tokens in groups of 48 (or 100): the last group is padded with
    # zero rows, which tie on every expert and route to the lowest indices
    run_both(token_group=token_group)


def test_shared_experts_match_jax():
    jcfg, _ = configs("deepseek-moe-16b")
    assert jcfg.moe.n_shared == 2
    run_both("deepseek-moe-16b", T=40)


def test_dead_pad_experts_match_jax():
    # granite's 40 experts (top 8) pad to 48; the 8 pads never get a token
    run_both("granite-moe-3b-a800m", n_experts=40, top_k=8)
    _, tcfg = configs("granite-moe-3b-a800m", n_experts=40, top_k=8)
    assert tcfg.padded_n_experts == 48


def test_route_breaks_ties_toward_the_lower_index():
    logits = torch.tensor([[0.0, 1.0, 1.0, 0.0, 1.0], [0.0] * 5])
    gates, idx = moe._route(logits, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    assert torch.allclose(gates, torch.full((2, 2), 0.5))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-moe-16b",
                                  "granite-moe-3b-a800m"])
def test_specs_and_capacity_match_jax(arch):
    jcfg, tcfg = configs(arch)
    want, got = jax_moe.moe_specs(jcfg), moe.moe_specs(tcfg)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert (got[name].shape, got[name].init) == (spec.shape, spec.init)
    for group in (1, 4, 37, 128, 4096):
        assert moe._group_capacity(group, tcfg) == jax_moe._group_capacity(
            group, jcfg)
