"""The port's jamba serving path against the JAX package on the smoke preset.

Jamba's pattern of 8 runs mamba mixers at 7 positions and attention at
position 4, MoE FFNs at the odd positions and MLPs at the even ones. Weights
come from the JAX ``init_params`` and are carried across with
``params_from_jax``; prompts are made with numpy from a seed. Bounds are
those of ``tests/test_torch_serve.py``: prefill logits 1e-4, decode logits
1e-3 (f32). Prompts stay at or below 128 tokens, where the JAX mamba
prefill pads no time step (``tests/test_torch_mamba.py`` covers longer
ones).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import model as JM
from repro.train.step import make_decode_step as jax_decode_step
from repro.train.step import make_prefill_step as jax_prefill_step
from repro_torch.configs import archs as torch_archs
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.train.step import make_decode_step, make_prefill_step

CPU = torch.device("cpu")
ARCH = "jamba-v0.1-52b"


def configs(**changes):
    """Jamba smoke in both packages, f32 by default; two pattern groups, so
    that layer l is group l // 8 at position l % 8."""
    changes.setdefault("dtype", "float32")
    changes.setdefault("n_layers", 16)
    j = dataclasses.replace(jax_archs.get_config(ARCH, "smoke"), **changes)
    t = dataclasses.replace(torch_archs.get_config(ARCH, "smoke"), **changes)
    return j, t


def models(**changes):
    jcfg, tcfg = configs(**changes)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg,
                            dtype=jnp.dtype(jcfg.dtype))
    model = Model(tcfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, CPU))
    return jcfg, params, tcfg, model


def prompts(B, T, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T),
                                                dtype=np.int32)


def grow(caches, P, total):
    """serve.py's growth of the attention caches from P to ``total`` slots;
    the mamba caches ("h", "conv") keep their size."""
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


def test_jamba_weights_carry_by_name_and_dtype():
    jcfg, params, tcfg, model = models(dtype="bfloat16")
    state = params_from_jax(jax.tree.map(np.asarray, params), tcfg, CPU)
    assert set(state) == set(model.state_dict())
    # layer 9 is group 1, position 1: a mamba mixer and an MoE FFN
    wg = np.asarray(params["pos1"]["ffn"]["wg"][1].astype(jnp.float32))
    assert state["layers.9.ffn.wg"].shape == (16, 64, 32)
    np.testing.assert_array_equal(state["layers.9.ffn.wg"].float().numpy(), wg)
    assert state["layers.9.ffn.router"].dtype == torch.float32
    assert state["layers.9.mixer.A_log"].dtype == torch.float32
    model.load_state_dict(state)
    for name in ("router", "A_log", "D", "dt_w", "dt_b"):
        part = "ffn" if name == "router" else "mixer"
        assert getattr(model.layers[9][part], name).dtype == torch.float32
    assert model.layers[9].mixer.in_proj.dtype == torch.bfloat16
    assert model.layers[12].mixer.wq.dtype == torch.bfloat16


@pytest.mark.parametrize("T", [24, 64])
def test_prefill_logits_match_jax(T):
    jcfg, params, tcfg, model = models()
    toks = prompts(2, T, tcfg.vocab_size)
    j_logits, _ = jax_prefill_step(jcfg)(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits = make_prefill_step(tcfg)(
            model, {"tokens": torch.from_numpy(toks).long()},
            model.alloc_cache(2, T))
    assert logits.shape == tuple(j_logits.shape)
    assert float(np.abs(logits.numpy() - np.asarray(j_logits)).max()) < 1e-4


def test_forward_aux_matches_jax():
    jcfg, params, tcfg, model = models()
    toks = prompts(2, 32, tcfg.vocab_size, seed=4)
    _, j_aux, _ = JM.forward(params, {"tokens": jnp.asarray(toks)}, jcfg,
                             mode="prefill")
    with torch.no_grad():
        _, aux = model(torch.from_numpy(toks).long(), model.alloc_cache(2, 32))
    assert aux.shape == (4,) and aux.dtype == torch.float32
    np.testing.assert_allclose(aux.numpy(), np.asarray(j_aux), rtol=1e-5,
                               atol=1e-6)
    assert float(aux[1]) > 0             # 8 MoE layers' load balance


def test_decode_steps_match_jax():
    jcfg, params, tcfg, model = models()
    B, P, G = 2, 20, 4
    toks = prompts(B, P + G, tcfg.vocab_size, seed=1)
    _, j_caches = jax_prefill_step(jcfg)(params,
                                         {"tokens": jnp.asarray(toks[:, :P])})
    j_caches = grow(j_caches, P, P + G)
    caches = model.alloc_cache(B, P + G)
    with torch.no_grad():
        make_prefill_step(tcfg)(
            model, {"tokens": torch.from_numpy(toks[:, :P]).long()}, caches)
    for t in range(P, P + G):
        j_logits, _, j_caches = jax_decode_step(jcfg)(
            params, j_caches, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            jnp.int32(t))
        with torch.no_grad():
            logits, _ = make_decode_step(tcfg)(
                model, caches, {"tokens": torch.from_numpy(
                    toks[:, t:t + 1]).long()}, t)
        err = float(np.abs(logits.numpy() - np.asarray(j_logits)).max())
        assert err < 1e-3, (t, err)
    # layer 12 (group 1, position 4) is attention; layer 9 mamba
    assert caches[12]["pos"].tolist() == list(range(P + G))
    j_h = np.asarray(j_caches["pos1"]["mixer"]["h"][1])
    assert float(np.abs(caches[9]["h"].numpy() - j_h).max()) < 1e-5


def test_greedy_tokens_match_jax_serve_loop():
    jcfg, params, tcfg, model = models()
    B, P, G = 2, 16, 6
    toks = prompts(B, P, tcfg.vocab_size, seed=2)
    logits, caches = jax_prefill_step(jcfg)(params, {"tokens": jnp.asarray(toks)})
    caches = grow(caches, P, P + G)
    token = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
    want = [token]
    for t in range(P, P + G):
        _, nxt, caches = jax_decode_step(jcfg)(params, caches,
                                               {"tokens": token}, jnp.int32(t))
        token = nxt[:, 0][:, None]
        want.append(token)
    want = np.asarray(jnp.concatenate(want, axis=1))

    got, stats = serve.generate(model, torch.from_numpy(toks).long(), G)
    assert got.shape == (B, G + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["logits_finite"]
    assert stats["prefill_kernel_launches"] == {"flash_attention_fwd": 0,
                                                "selective_scan": 0}


def test_serve_main_on_cpu_records_regions():
    gen, stats = serve.main(["--arch", ARCH, "--device", "cpu", "--batch",
                             "2", "--prompt-len", "8", "--gen", "3"])
    assert gen.shape == (2, 4)
    assert 0 <= int(gen.min()) and int(gen.max()) < 256
    names = {c["name"] for c in stats["tree"]["children"]}
    assert {"serve/prefill", "serve/decode_step"} <= names
    assert stats["prefill_kernel_launches"] == {"flash_attention_fwd": 0,
                                                "selective_scan": 0}


def test_caches_follow_the_mixer_of_each_layer():
    _, tcfg = configs(dtype="bfloat16")
    caches = Model(tcfg, CPU).alloc_cache(3, 40)
    for l, cache in enumerate(caches):
        if l % 8 == 4:
            assert set(cache) == {"k", "v", "pos"}
            assert cache["k"].shape == (3, 40, 4, 16)
        else:
            assert set(cache) == {"h", "conv"}
            assert cache["h"].shape == (3, 128, 4)
            assert cache["h"].dtype == torch.float32
            assert cache["conv"].shape == (3, 3, 128)
            assert cache["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", [ARCH, "granite-moe-3b-a800m"])
def test_training_mamba_or_moe_raises_with_its_roadmap_entry(arch):
    cfg = torch_archs.get_config(arch, "smoke")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, CPU, trainable=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, CPU)(torch.zeros(1, 8, dtype=torch.long), mode="train")
