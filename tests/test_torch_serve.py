"""The port's serving path against the JAX package on the yi-6b smoke preset.

Weights come from the JAX ``init_params`` and are carried across with
``params_from_jax``; prompts are made with numpy from a seed. Bounds are
those of ``tests/test_models.py``: prefill logits 1e-4, decode logits 1e-3
(f32). T=24 takes the JAX naive attention path, T=64 its blockwise path
(``attn_block`` is 32 at the smoke preset); the port takes the plain
version of its flash-attention kernel on the CPU in both.
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
from repro.train.step import make_decode_step as jax_decode_step
from repro.train.step import make_prefill_step as jax_prefill_step
from repro_torch.configs import archs as torch_archs
from repro_torch.core import regions
from repro_torch.core.collector import reset_global_collector
from repro_torch.interop import params_from_jax, tensor_from_numpy
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import serve
from repro_torch.models import common
from repro_torch.models.model import Model
from repro_torch.train.step import (CapturedDecode, make_decode_step,
                                    make_prefill_step)

CPU = torch.device("cpu")


def configs(**changes):
    """The same yi-6b smoke config in both packages, f32 by default."""
    changes.setdefault("dtype", "float32")
    j = dataclasses.replace(jax_archs.get_config("yi-6b", "smoke"), **changes)
    t = dataclasses.replace(torch_archs.get_config("yi-6b", "smoke"), **changes)
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
    """serve.py's cache growth from P to ``total`` slots."""
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


@pytest.mark.parametrize("arch", sorted(jax_archs.ARCHS))
@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_configs_match_jax(arch, preset):
    j = jax_archs.get_config(arch, preset)
    t = torch_archs.get_config(arch, preset)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.head_dim, j.padded_vocab_size, j.n_groups) == (
        t.head_dim, t.padded_vocab_size, t.n_groups)


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
    assert caches[0]["pos"].tolist() == list(range(P + G))


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


def test_padded_vocab_logits_are_masked_like_jax():
    # vocab 250 pads to 256: the tail must be -1e30 in both packages
    jcfg, params, tcfg, model = models(vocab_size=250)
    assert tcfg.padded_vocab_size == 256
    toks = prompts(2, 12, tcfg.vocab_size, seed=3)
    j_logits, _ = jax_prefill_step(jcfg)(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits = make_prefill_step(tcfg)(
            model, {"tokens": torch.from_numpy(toks).long()},
            model.alloc_cache(2, 12))
    assert (logits[..., 250:] == -1e30).all()
    assert float(np.abs(logits.numpy() - np.asarray(j_logits)).max()) < 1e-4


def test_yi_vocab_needs_no_padding():
    cfg = torch_archs.get_config("yi-6b", "full")
    assert cfg.padded_vocab_size == cfg.vocab_size == 64000


def test_serve_main_on_cpu_records_regions():
    gen, stats = serve.main(["--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--gen", "3"])
    assert gen.shape == (2, 4)
    assert 0 <= int(gen.min()) and int(gen.max()) < 256
    names = {c["name"] for c in stats["tree"]["children"]}
    assert {"serve/prefill", "serve/decode_step"} <= names
    assert stats["device"] == "cpu" and stats["peak_memory_bytes"] is None


def test_serve_rejects_telemetry():
    # a malformed port is rejected; without a card, --telemetry with no
    # --device cpu raises like any other serve call
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--telemetry", "--telemetry-port",
                    "http"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            serve.main(["--telemetry", "--batch", "1", "--prompt-len", "4",
                        "--gen", "1"])


def test_fenced_regions_record_on_cpu():
    _, _, _, model = models()
    collector = reset_global_collector()
    regions.configure(fence=True)
    try:
        serve.generate(model, torch.from_numpy(prompts(1, 8, 256)).long(), 2)
    finally:
        regions.configure(fence=False)
    names = [e.name for e in collector.drain()]
    assert names.count("serve/decode_step") == 2
    assert names.count("serve/prefill") == 1
    assert flash_attention.launches == 0


def test_bf16_weights_carry_bit_exact():
    jcfg, tcfg = configs(dtype="bfloat16")
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    state = params_from_jax(jax.tree.map(np.asarray, params), tcfg, CPU)
    wq = np.asarray(params["pos0"]["mixer"]["wq"][0])
    assert state["layers.0.mixer.wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["layers.0.mixer.wq"].view(torch.int16).numpy(),
        wq.view(np.int16))
    model = Model(tcfg, CPU)
    model.load_state_dict(state)
    assert model.final_norm.dtype == torch.float32
    assert model.layers[0].mixer.wq.dtype == torch.bfloat16


def test_tensor_from_numpy_keeps_float32():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tensor_from_numpy(a, CPU)
    assert t.dtype == torch.float32 and t.tolist() == a.tolist()


@pytest.mark.parametrize("T", [1, 7])
def test_rms_norm_and_rope_match_jax(T):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, T, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    pos = np.arange(3, 3 + T, dtype=np.int32)
    j = jax_common.apply_rope(
        jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
        jnp.asarray(pos), 5e6)
    t = common.apply_rope(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
        torch.from_numpy(pos), 5e6)
    assert float(np.abs(t.numpy() - np.asarray(j)).max()) < 1e-5


def test_seeded_init_is_stable_and_seed_dependent():
    _, tcfg = configs()
    a = Model(tcfg, CPU).init_weights(0)
    b = Model(tcfg, CPU).init_weights(0)
    c = Model(tcfg, CPU).init_weights(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(("wq", "embed")):
            assert not torch.equal(pa, pc), name


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
def test_vlm_and_audio_build_and_unknown_mixer_raises(arch):
    # the vlm's cross-attention and the audio model's frames build; a mixer
    # the port does not have raises
    cfg = torch_archs.get_config(arch, "smoke")
    model = Model(cfg, CPU)
    assert ("embed" in dict(model.named_parameters())) == (
        cfg.input_mode != "frames")
    bad = dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, mixer="conv") for s in cfg.pattern))
    with pytest.raises(ValueError, match="unknown mixer 'conv'"):
        Model(bad, CPU)


def _served_smoke(arch):
    """A smoke model of ``arch`` with random weights; gemma3's local layers
    get a window of 8, which the prompts below pass."""
    cfg = torch_archs.get_config(arch, "smoke")
    if arch == "gemma3-12b":
        cfg = dataclasses.replace(cfg, pattern=tuple(
            dataclasses.replace(s, window=8 if s.window else None)
            for s in cfg.pattern))
    return cfg, Model(cfg, CPU).init_weights(0)


SERVED = ["yi-6b", "jamba-v0.1-52b", "gemma3-12b", "xlstm-125m"]


@pytest.mark.parametrize("arch", SERVED)
def test_decode_at_a_tensor_position_is_bit_identical(arch):
    # the position as a 0-d tensor, as a captured step takes it, gives the
    # same logits and caches as a Python int, bit for bit
    cfg, model = _served_smoke(arch)
    B, P, G = 2, 13, 5
    toks = torch.from_numpy(prompts(B, P + G, cfg.vocab_size, seed=4)).long()
    runs = []
    for as_tensor in (False, True):
        caches = model.alloc_cache(B, P + G)
        with torch.no_grad():
            logits = [make_prefill_step(cfg)(model, {"tokens": toks[:, :P]},
                                             caches)]
            for t in range(P, P + G):
                pos = torch.tensor(t, dtype=torch.int32) if as_tensor else t
                logits.append(make_decode_step(cfg)(
                    model, caches, {"tokens": toks[:, t:t + 1]}, pos)[0])
        runs.append((logits, caches))
    (la, ca), (lb, cb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for a, b in zip(ca, cb):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_captured_decode_on_a_cpu_model_raises():
    cfg, model = _served_smoke("yi-6b")
    with pytest.raises(ValueError, match="CUDA card"):
        CapturedDecode(model, model.alloc_cache(1, 4), 1)


TOKEN_ARCHS = sorted(a for a in jax_archs.ARCHS
                     if jax_archs.get_config(a).input_mode == "tokens")


def test_the_port_serves_what_the_reference_serves():
    # src/repro/launch/serve.py refuses the two archs without token input
    assert len(TOKEN_ARCHS) == 8
    assert sorted(set(jax_archs.ARCHS) - set(TOKEN_ARCHS)) == [
        "llama-3.2-vision-11b", "musicgen-large"]


@pytest.mark.parametrize("arch", sorted(jax_archs.ARCHS))
def test_serve_main_on_cpu(arch):
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "8", "--gen",
            "3"]
    if arch not in TOKEN_ARCHS:
        with pytest.raises(SystemExit):
            serve.main(argv + ["--device", "cpu"])
        return
    gen, stats = serve.main(argv + ["--device", "cpu"])
    cfg = torch_archs.get_config(arch, "smoke")
    assert gen.shape == (2, 4)
    assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size
    assert stats["logits_finite"] and not stats["decode_captured"]
    assert set(stats["decode_step_ms"]) == {"min", "mean", "max"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            serve.main(argv)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_greedy_tokens_match_jax_on_every_served_arch(arch):
    # each arch's smoke preset (gemma3's windows cut to 8), weights from
    # the JAX init_params, against the JAX serve loop with its cache growth
    def cfg_of(archs):
        cfg = dataclasses.replace(archs.get_config(arch, "smoke"),
                                  dtype="float32")
        return dataclasses.replace(cfg, pattern=tuple(
            dataclasses.replace(s, window=8 if s.window else None)
            for s in cfg.pattern))

    jcfg, tcfg = cfg_of(jax_archs), cfg_of(torch_archs)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = Model(tcfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, CPU))
    B, P, G = 2, 12, 4
    toks = prompts(B, P, tcfg.vocab_size, seed=11)
    logits, caches = jax_prefill_step(jcfg)(params,
                                            {"tokens": jnp.asarray(toks)})
    want_logits = np.asarray(logits)
    caches = grow(caches, P, P + G)
    token = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
    want = [token]
    for t in range(P, P + G):
        _, nxt, caches = jax_decode_step(jcfg)(params, caches,
                                               {"tokens": token}, jnp.int32(t))
        token = nxt[:, 0][:, None]
        want.append(token)
    got, stats = serve.generate(model, torch.from_numpy(toks).long(), G)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.concatenate(want, axis=1)))
    assert float(np.abs(stats["prefill_logits"].numpy()
                        - want_logits).max()) < 1e-4


def _spans(prof, prefix):
    """Names of the profiler's spans that start with ``prefix``, in the
    order they opened."""
    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.name.startswith(prefix)]


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-v0.1-52b"])
def test_generate_names_every_stretch_and_tracing_changes_nothing(arch):
    # the regions of a call, in order, as collector events and as
    # profiler spans; no capture on the CPU. A traced call gives the
    # untraced call's tokens and logits, bit for bit
    _, model = _served_smoke(arch)
    toks = torch.from_numpy(prompts(2, 8, 256, seed=3)).long()
    want = ["serve/alloc_cache", "serve/prefill", "serve/prefill_readback",
            *["serve/decode_step"] * 3, "serve/finish"]
    collector = reset_global_collector()
    plain, plain_stats = serve.generate(model, toks, 3)
    assert [e.name for e in collector.drain()] == want
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced, stats = serve.generate(model, toks, 3)
    assert _spans(prof, "serve/") == want
    assert torch.equal(traced, plain)
    for key in ("prefill_logits", "decode_logits"):
        assert torch.equal(stats[key], plain_stats[key])
