"""Training yi-6b across ranks: the port's mesh-sharding layer on DTensor.

Four gloo ranks on the CPU run ``launch.train.main`` (2 steps, smoke
preset in f32, B 4, T 32) at meshes (2,2), (4,1) and (1,4), and with 2 kv
heads (GQA: the flash wrapper cuts k and v to the kv heads of each rank's q
heads) at model 2 and 4, and with 2 q heads at model 4 (the fused head
dimension splits inside a head, so it is gathered before the reshape) and a
vocabulary of 250 padded to 256 (the loss masks the pad).
They rendezvous through a ``FileStore`` under the test's temporary
directory, never a fixed port, and each spawn has its own timeout. Every
run is held to the single-process port run on the same weights (losses
within 1e-5 relative; the first step's gradients, gathered, within 1e-5 of
max|ref|) and to ``jax.grad`` of the JAX package's loss on those weights
(1e-4, the bound of ``check_gradients``). Parameters after the Adam steps
are not compared element by element: Adam's first steps move each weight
by about lr·sign(g), and a gradient near 0 may flip sign under another
summation order. A checkpoint saved at (2,2) resumes on 2 ranks at (1,2)
through ``reshard_state`` and continues the unbroken run's losses.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro_torch.configs import archs as torch_archs
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.interop import params_from_jax
from repro_torch.launch import train
from repro_torch.models.model import Model
from test_torch_train_gemma3 import jax_loss_and_grads, jax_params_from_port, rel
from torch_rank_workers import run_ranks, train_runs

CPU = torch.device("cpu")
ARGV = ["--device", "cpu", "--batch", "4", "--seq", "32"]
# name: (--model-parallel on 4 ranks, config changes)
RUNS = {
    "2x2": (2, {}),
    "4x1": (1, {}),
    "1x4": (4, {}),
    "kv2-model2": (2, {"n_kv_heads": 2}),
    "kv2-model4": (4, {"n_kv_heads": 2}),
    "heads2-model4": (4, {"n_heads": 2, "n_kv_heads": 1,
                          "vocab_size": 250}),
}
VARIANTS = {"base": {}, "kv2": {"n_kv_heads": 2},
            "heads2": {"n_heads": 2, "n_kv_heads": 1, "vocab_size": 250}}


def variant_of(name):
    changes = RUNS[name][1]
    return next(v for v, c in VARIANTS.items() if c == changes)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every mesh run on 4 ranks (one spawn), the save at (2,2) among
    them, then the resume on 2 ranks at (1,2)."""
    tmp = tmp_path_factory.mktemp("sharded")
    ckpt = str(tmp / "ckpt")
    runs = [(name, changes, ARGV + ["--steps", "2", "--model-parallel",
                                    str(mp)])
            for name, (mp, changes) in RUNS.items()]
    runs.append(("save-2x2", {}, ARGV + [
        "--steps", "2", "--model-parallel", "2", "--ckpt-dir", ckpt]))
    out = run_ranks(train_runs, 4, runs, store_dir=str(tmp / "s4"),
                    timeout=240)[0]
    resumed = run_ranks(train_runs, 2, [("resume-1x2", {}, ARGV + [
        "--steps", "4", "--model-parallel", "2", "--ckpt-dir", ckpt,
        "--resume"])], store_dir=str(tmp / "s2"), timeout=120)[0]
    out.update(resumed)
    out["ckpt"] = ckpt
    return out


@pytest.fixture(scope="module")
def single():
    """The single-process port run of each variant (4 steps of the base
    config, for the resume check), no process group."""
    return train_runs(0, 1, [(v, c, ARGV + ["--steps", "4" if v == "base"
                                            else "2"])
                             for v, c in VARIANTS.items()])


@pytest.fixture(scope="module")
def jax_grads():
    """(loss, gradients by port name) of ``jax.grad`` of the JAX loss on
    the port's seed-0 weights and the launcher's first batch."""
    out = {}
    for v, changes in VARIANTS.items():
        changes = dict(dtype="float32", **changes)
        tcfg = dataclasses.replace(torch_archs.get_config("yi-6b", "smoke"),
                                   **changes)
        jcfg = dataclasses.replace(jax_archs.get_config("yi-6b", "smoke"),
                                   **changes)
        model = Model(tcfg, CPU, trainable=True).init_weights(0)
        batch = SyntheticTokens(tcfg, DataConfig(batch=4, seq_len=32)
                                ).batch_at(0)
        (loss, _m), grads = jax_loss_and_grads(
            jax_params_from_port(model, jcfg), batch, jcfg)
        out[v] = (float(loss), params_from_jax(
            jax.tree.map(np.asarray, grads), tcfg, CPU))
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_the_single_process_run(sharded, single, name):
    losses = sharded[name][0]
    want = single[variant_of(name)][0][:2]
    assert len(losses) == 2
    for got, ref in zip(losses, want):
        assert abs(got - ref) <= 1e-5 * abs(ref), (name, losses, want)


@pytest.mark.parametrize("name", list(RUNS))
def test_first_gradients_match_the_single_process_run(sharded, single, name):
    grads = sharded[name][1]
    want = single[variant_of(name)][1]
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert g.shape == want[n].shape, n        # gathered: global shapes
        assert rel(g, want[n]) < 1e-5, (name, n, rel(g, want[n]))


@pytest.mark.parametrize("name", list(RUNS))
def test_first_gradients_match_jax(sharded, jax_grads, name):
    loss, want = jax_grads[variant_of(name)]
    losses, grads = sharded[name]
    assert abs(losses[0] - loss) < 1e-5 * abs(loss)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert rel(g, want[n]) < 1e-4, (name, n, rel(g, want[n]))


def test_checkpoint_saved_at_2x2_resumes_at_1x2(sharded, single):
    saved = sharded["save-2x2"][0]
    resumed = sharded["resume-1x2"][0]
    unbroken = single["base"][0]
    assert len(resumed) == 2
    for got, ref in zip(saved + resumed, unbroken):
        assert abs(got - ref) <= 1e-5 * abs(ref), (saved, resumed, unbroken)


def test_the_checkpoint_holds_unsharded_arrays_written_once(sharded):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.model import param_shapes

    ckpt = CheckpointManager(sharded["ckpt"], async_save=False)
    assert ckpt.available_steps() == [2, 4]
    step, state, _ = ckpt.restore(2)
    shapes = param_shapes(torch_archs.get_config("yi-6b", "smoke"))
    for name, shape in shapes.items():
        assert tuple(state["params"][name].shape) == shape, name
        assert tuple(state["opt_state"]["m"][name].shape) == shape, name
    assert int(state["opt_state"]["step"]) == 2
    assert not [n for n in os.listdir(sharded["ckpt"]) if ".tmp-" in n]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b",
                                  "xlstm-125m", "jamba-v0.1-52b",
                                  "llama-3.2-vision-11b", "musicgen-large"])
def test_families_without_a_sharded_path_raise(arch):
    cfg = torch_archs.get_config(arch, "smoke")
    with pytest.raises(ValueError, match="ROADMAP Queue 1, item 9"):
        train.check_shardable(cfg)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-32b", "minicpm-2b",
                                  "gemma3-12b"])
def test_dense_families_are_shardable(arch):
    train.check_shardable(torch_archs.get_config(arch, "smoke"))


def test_a_backward_on_another_thread_recomputes_as_the_forward(tmp_path):
    """On a card the backward, and with it the remat's recompute, runs on
    the autograd engine's thread. Here the sharded step's backward runs on
    a thread of its own (a one-rank gloo group, a (1,1) mesh), and the
    gradients are the plain step's."""
    import threading

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.sharding import rules as R
    from repro_torch.train.losses import chunked_ce_loss

    cfg = dataclasses.replace(torch_archs.get_config("yi-6b", "smoke"),
                              dtype="float32")
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticTokens(
        cfg, DataConfig(batch=2, seq_len=32)).batch_at(0).items()}

    def loss_of(model, b):
        hidden, _aux = model(b["tokens"], mode="train")
        return R.constrain(chunked_ce_loss(hidden, model.lm_head, b["labels"],
                                           cfg)[0], ())

    plain = Model(cfg, CPU, trainable=True).init_weights(0)
    loss_of(plain, batch).backward()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh_for(1, 1)
        rules = R.make_rules(mesh)
        model = train.place_model(
            Model(cfg, CPU, trainable=True).init_weights(0), mesh, rules)
        with R.sharding_context(mesh, rules):
            loss = loss_of(model, train.place_batch(batch, mesh, rules))
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join()
        for n, p in model.named_parameters():
            want = dict(plain.named_parameters())[n].grad
            assert torch.equal(p.grad.full_tensor(), want), n
    finally:
        dist.destroy_process_group()
