"""The port's training path against the JAX package.

The optimizer is held to ``repro.optim.adamw`` on identical gradients, the
loss to ``repro.train.losses.chunked_ce_loss``, and the whole train step to
the JAX step on the yi-6b ``smoke`` preset with 2 kv heads and 2 layers,
weights carried by ``params_from_jax``. T=32 takes the JAX naive attention
path and T=64 its blockwise path (``attn_block`` is 32 at the smoke
preset); the port takes the plain versions of its flash-attention kernels
on the CPU in both. Gradients are compared by name, max|err| / max|ref|
below 1e-4 in f32 (``tests/test_kernels_flash.py``). bf16 is held loosely
(5e-2): both sides round activations to bf16, in different places, and sum
the embedding gradient's duplicate tokens in bf16.

Adam's first update is about lr·sign(g), so a gradient element near zero
whose sign differs between frameworks moves by up to 2·lr: post-step
weights are not compared elementwise, losses over steps are.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.train.losses import chunked_ce_loss as jax_ce
from repro.train.step import make_eval_step as jax_eval_step
from repro.train.step import make_train_step as jax_train_step
from repro_torch.configs import archs as torch_archs
from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import train
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.losses import IGNORE, chunked_ce_loss
from repro_torch.train.step import make_eval_step, make_train_step

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _tree(rng, scale=1.0):
    shapes = {"embed": (8, 4), "final_norm": (4,), "lm_head": (4, 8),
              "pos0": {"mixer": {"wq": (4, 4), "q_norm": (4,)},
                       "norm_ffn": (4,), "A_log": (3, 2), "D": (3,)}}

    def mk(t):
        return {k: mk(v) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in t.items()}

    return mk(shapes)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
def test_schedules_match_jax(schedule):
    cfg = dict(lr=3e-4, schedule=schedule, warmup_steps=5, total_steps=40)
    jfn = jax_adamw.schedule_fn(jax_adamw.AdamWConfig(**cfg))
    tfn = adamw.schedule_fn(adamw.AdamWConfig(**cfg))
    for step in range(0, 45):
        want = float(jfn(jnp.int32(step)))
        assert abs(tfn(step) - want) <= 1e-6 * cfg["lr"] + 1e-12, step


@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
@pytest.mark.parametrize("clip,grad_scale", [
    (1.0, 10.0),      # norm well above 1: clipped
    (1.0, 0.01),      # below: not clipped
    (None, 10.0),     # no clipping at all
])
def test_adamw_matches_jax_on_identical_grads(schedule, clip, grad_scale):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    ocfg = dict(lr=1e-2, schedule=schedule, warmup_steps=2, total_steps=6,
                clip_norm=clip)
    jcfg, tcfg = jax_adamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_adamw.init_state(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in _flat(params)}
    ts = adamw.init_state(tp)
    for _ in range(3):
        grads = _tree(rng, grad_scale)
        jp, js, jm = jax_adamw.apply_updates(
            jp, jax.tree.map(jnp.asarray, grads), js, jcfg)
        tm = adamw.apply_updates(
            tp, {n: torch.from_numpy(a) for n, a in _flat(grads)}, ts, tcfg)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < 1e-5
        assert abs(tm["lr"] - float(jm["lr"])) < 1e-9
    assert ts["step"] == int(js["step"]) == 3
    for key, jtree, ttree in (("p", jp, tp), ("m", js["m"], ts["m"]),
                              ("v", js["v"], ts["v"])):
        for name, want in _flat(jax.tree.map(np.asarray, jtree)):
            np.testing.assert_allclose(ttree[name].numpy(), want, rtol=0,
                                       atol=1e-6, err_msg=f"{key} {name}")


@pytest.mark.parametrize("name,decays", [
    ("layers.0.mixer.wq", True), ("embed", True), ("lm_head", True),
    ("final_norm", False), ("layers.3.norm_ffn", False),
    ("layers.0.mixer.q_norm", False), ("layers.1.mixer.A_log", False),
    ("layers.1.mixer.D", False), ("layers.1.mixer.dt_b", False),
    ("layers.2.cross.gate", False),
])
def test_decay_mask_matches_jax(name, decays):
    class Key:
        def __init__(self, key):
            self.key = key

    path = [Key(k) for k in name.split(".")]
    assert jax_adamw._decay_mask(path) is decays
    assert adamw.decay_mask(name) is decays


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,chunk", [(40, 16), (64, 64), (24, 256)])
def test_chunked_ce_matches_jax(T, chunk):
    # vocab 250 pads to 256; T % chunk pads the sequence; some labels ignored
    jcfg = dataclasses.replace(jax_archs.get_config("yi-6b", "smoke"),
                               vocab_size=250, dtype="float32")
    tcfg = dataclasses.replace(torch_archs.get_config("yi-6b", "smoke"),
                               vocab_size=250, dtype="float32")
    rng = np.random.default_rng(T)
    h = rng.standard_normal((2, T, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 256)) * 0.1).astype(np.float32)
    lab = rng.integers(0, 250, (2, T)).astype(np.int32)
    lab[0, :7] = IGNORE
    lab[1, -3:] = IGNORE

    def jloss(h, w):
        return jax_ce(h, w, jnp.asarray(lab), jcfg, chunk=chunk)

    (jl, jm), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(h, w)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl, tm = chunked_ce_loss(th, tw, torch.from_numpy(lab), tcfg, chunk=chunk)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) < 1e-5
    for k in ("ce", "z_loss", "tokens"):
        got = float(tm[k].detach())
        assert abs(got - float(jm[k])) < 1e-4 * max(1, abs(float(jm[k]))), k
    assert float(tm["tokens"]) == float((lab != IGNORE).sum())
    for a, b in ((th.grad, jgh), (tw.grad, jgw)):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max() / np.abs(b).max()) < 1e-5


def test_all_labels_ignored_gives_zero_loss():
    tcfg = torch_archs.get_config("yi-6b", "smoke")
    h = torch.randn(1, 8, 64, requires_grad=True)
    w = torch.randn(64, 256)
    loss, m = chunked_ce_loss(h, w, torch.full((1, 8), IGNORE), tcfg)
    loss.backward()
    assert float(loss) == 0.0 and float(m["tokens"]) == 1.0
    assert float(h.grad.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the train step against the JAX step
# ---------------------------------------------------------------------------

def configs(**changes):
    changes = dict(dict(dtype="float32", n_kv_heads=2, n_layers=2), **changes)
    j = dataclasses.replace(jax_archs.get_config("yi-6b", "smoke"), **changes)
    t = dataclasses.replace(torch_archs.get_config("yi-6b", "smoke"), **changes)
    return j, t


def models(**changes):
    jcfg, tcfg = configs(**changes)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = Model(tcfg, CPU, trainable=True)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, CPU))
    return jcfg, params, tcfg, model


def batch_np(B, T, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, T + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = IGNORE
    return {"tokens": toks[:, :-1], "labels": labels}


def torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def jax_loss_and_grads(params, batch, cfg):
    """The JAX ``loss_fn`` of ``make_train_step``, differentiated."""
    def loss_fn(p, b):
        hidden, aux, _ = JM.forward(p, b, cfg, mode="train")
        lm_head = p["lm_head"].astype(jnp.dtype(cfg.dtype))
        loss, metrics = jax_ce(hidden, lm_head, b["labels"], cfg)
        return loss + aux[0], metrics

    return jax.value_and_grad(loss_fn, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


NO_UPDATE = adamw.AdamWConfig(lr=0.0, weight_decay=0.0, clip_norm=None)


@pytest.mark.parametrize("T", [32, 64])
def test_train_step_gradients_match_jax(T):
    jcfg, params, tcfg, model = models()
    batch = batch_np(2, T, seed=T)
    (jl, jm), jg = jax_loss_and_grads(params, batch, jcfg)
    metrics = make_train_step(tcfg, NO_UPDATE)(
        model, adamw.init_state(dict(model.named_parameters())),
        torch_batch(batch))
    assert abs(float(metrics["loss"]) - float(jl)) < 1e-5 * abs(float(jl))
    for k in ("ce", "z_loss", "tokens"):
        assert abs(float(metrics[k]) - float(jm[k])) < 1e-4, k
    assert float(metrics["moe_aux"]) == float(metrics["moe_load_balance"]) == 0
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg, CPU)
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(want)
    for name, p in names.items():
        assert p.grad.dtype == torch.float32, name
        assert rel(p.grad, want[name]) < 1e-4, (name, rel(p.grad, want[name]))


@pytest.mark.parametrize("T,microbatches", [(32, 1), (64, 1), (64, 2)])
def test_losses_over_three_steps_match_jax(T, microbatches):
    jcfg, params, tcfg, model = models()
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jax_train_step(jcfg, jax_adamw.AdamWConfig(**ocfg),
                                   microbatches=microbatches))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**ocfg),
                            microbatches=microbatches)
    jstate = jax_adamw.init_state(params)
    tstate = adamw.init_state(dict(model.named_parameters()))
    for step in range(3):
        batch = batch_np(4, T, seed=100 + step)
        params, jstate, jm = jstep(params, jstate,
                                   jax.tree.map(jnp.asarray, batch))
        tm = tstep(model, tstate, torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert abs(tm["lr"] - float(jm["lr"])) < 1e-9
    assert tstate["step"] == 3


def test_bf16_train_step_gradients_match_jax_loosely():
    jcfg, params, tcfg, model = models(dtype="bfloat16")
    batch = batch_np(2, 64, seed=7)
    (jl, _), jg = jax_loss_and_grads(params, batch, jcfg)
    metrics = make_train_step(tcfg, NO_UPDATE)(
        model, adamw.init_state(dict(model.named_parameters())),
        torch_batch(batch))
    assert abs(float(metrics["loss"]) - float(jl)) < 1e-2
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg, CPU)
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert rel(p.grad, want[name]) < 5e-2, (name, rel(p.grad, want[name]))


def test_eval_step_matches_jax():
    jcfg, params, tcfg, model = models()
    batch = batch_np(2, 40, seed=3)
    jm = jax_eval_step(jcfg)(params, jax.tree.map(jnp.asarray, batch))
    tm = make_eval_step(tcfg)(model, torch_batch(batch))
    for k in ("loss", "ce", "z_loss", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) < 1e-4 * max(1, abs(float(jm[k]))), k
    assert all(p.grad is None for p in model.parameters())


def test_remat_none_gives_the_same_gradients_as_full():
    grads = []
    for remat in ("full", "none"):
        _, _, tcfg, model = models(remat=remat)
        make_train_step(tcfg, NO_UPDATE)(
            model, adamw.init_state(dict(model.named_parameters())),
            torch_batch(batch_np(2, 48, seed=5)))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.allclose(g, grads[1][name], rtol=1e-5, atol=1e-7), name


def test_dots_remat_saves_products_and_matches_full():
    # "dots" keeps every x @ W product (aten.mm) of the forward, so the
    # backward recomputes no mm that "full" recomputes, and the gradients
    # are the same; an unknown policy raises
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    batch = torch_batch(batch_np(2, 48, seed=5))
    mms, grads = {}, {}
    for remat in ("full", "dots", "none"):
        _, _, tcfg, model = models(remat=remat)
        hidden, _ = model(batch["tokens"], mode="train")
        with CountMM() as count:
            hidden.float().square().sum().backward()
        mms[remat] = count.n
        # lm_head takes no part in this loss
        grads[remat] = {n: p.grad for n, p in model.named_parameters()
                        if n != "lm_head"}
    # each of the 2 layers has 7 forward products (wq, wk, wv, wo, wg, wi,
    # wo); "full" recomputes the first 6 (the recompute stops early, and
    # the backward needs no output of the FFN's wo), "dots" none
    assert mms["full"] - mms["dots"] == 2 * 6
    assert mms["dots"] == mms["none"]
    for remat in ("dots", "none"):
        for name, g in grads["full"].items():
            assert torch.allclose(g, grads[remat][name], rtol=1e-5,
                                  atol=1e-7), (remat, name)
    _, _, tcfg, model = models(remat="some")
    with pytest.raises(ValueError, match="unknown remat policy 'some'"):
        model(torch.zeros(1, 8, dtype=torch.long), mode="train")


def test_train_mode_needs_a_trainable_model():
    _, tcfg = configs()
    model = Model(tcfg, CPU)
    with pytest.raises(ValueError, match="trainable"):
        model(torch.zeros(1, 8, dtype=torch.long), mode="train")


def test_trainable_weights_are_f32_masters_with_grads():
    _, tcfg = configs(dtype="bfloat16")
    model = Model(tcfg, CPU, trainable=True).init_weights(0)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, name
    served = Model(tcfg, CPU).init_weights(0)
    assert served.layers[0].mixer.wq.dtype == torch.bfloat16


def test_microbatches_must_divide_the_batch():
    _, _, tcfg, model = models()
    step = make_train_step(tcfg, NO_UPDATE, microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(model, adamw.init_state(dict(model.named_parameters())),
             torch_batch(batch_np(4, 16)))


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--arch", "yi-6b", "--preset", "smoke",
        "--batch", "4", "--seq", "64", "--schedule", "constant"]


def test_train_and_resume(tmp_path):
    # mirrors tests/test_train_loop.py: constant schedule, since cosine
    # decay depends on total_steps, which differs between the runs
    ckpt = str(tmp_path / "ck")
    losses_full, stats = train.main(BASE + ["--steps", "8"])
    train.main(BASE + ["--steps", "4", "--ckpt-dir", ckpt,
                       "--ckpt-every", "100"])
    losses_resumed, _ = train.main(BASE + ["--steps", "8", "--ckpt-dir", ckpt,
                                           "--resume"])
    assert len(losses_resumed) == 4
    assert np.allclose(losses_full[4:], losses_resumed, rtol=1e-4), (
        losses_full[4:], losses_resumed)
    assert len(stats["step_ms"]) == 8 and stats["peak_memory_bytes"] is None
    assert stats["launches"] == [{"flash_attention_fwd": 0,
                                  "flash_attention_bwd_dq": 0,
                                  "flash_attention_bwd_dkv": 0,
                                  "selective_scan": 0,
                                  "selective_scan_bwd": 0}] * 8
    names = {c["name"] for c in stats["tree"]["children"]}
    assert names == {"train/step"}


def test_loss_decreases_on_structured_stream():
    losses, _ = train.main([
        "--device", "cpu", "--arch", "yi-6b", "--preset", "smoke",
        "--steps", "80", "--batch", "8", "--seq", "64", "--d-model", "128",
        "--layers", "2", "--lr", "1e-2", "--schedule", "constant"])
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first - 0.1, (first, last)


def test_trace_out_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace.json"
    train.main(BASE + ["--steps", "2", "--trace-out", str(out)])
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert {"train/step", "train/data", "train/compute"} <= names


def test_indivisible_model_parallel_raises_value_error():
    # one process, no process group: a world of 1 rank, which 2 does not
    # divide (the mesh itself is tested in test_torch_sharded_train.py)
    with pytest.raises(ValueError, match="--model-parallel 2 does not divide"):
        train.main(BASE + ["--steps", "1", "--model-parallel", "2"])


def test_train_without_device_flag_raises_on_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.main(["--steps", "1", "--batch", "1", "--seq", "8"])
    assert flash_attention.launches == 0
