"""Serving on DTensor (dense, MoE and hybrid) and MoE and jamba training
across ranks.

Four gloo ranks on the CPU, one spawn for each kind of run, rendezvous
through a ``FileStore`` under the test's temporary directory:

* greedy serving of yi-6b, deepseek-moe-16b and jamba-v0.1-52b (smoke,
  f32, B 4, a prompt of 8, 4 new tokens) at mesh (2,2): prefill under the
  prefill rules and decode under the decode rules, weights and caches
  DTensors (the KV cache's slots split over ``"model"``, decode attending
  them with a partial softmax combined across ranks; mamba's state and
  conv tail split over ``"inner"``, stepped in place on each rank's
  channels; the MoE experts left where they are stored, the tokens
  moving to them); and yi-6b with one sequence, whose cache's slots the
  decode rules split over both axes. The tokens equal the one-process
  run's, and every step's logits lie within 1e-5 of max|ref|;
* training (granite-moe-3b-a800m, deepseek-moe-16b and jamba-v0.1-52b,
  smoke, f32, B 4, T 64, 2 steps) through ``launch.train.main`` at (2,2):
  the losses within 1e-5 relative of the one-process run's, the first
  step's gathered gradients within 1e-5 of max|ref| of the one-process
  run's and within 1e-4 of ``jax.grad`` of the JAX package's loss on the
  same weights (the bounds of the dense family's sharded tests). The
  batch's 256 tokens make one routing group, which spans both batch
  shards, so routing runs on the gathered batch and the capacity and
  last-slot quirk are the one-process run's. At smoke size the experts
  are gathered (their weights are fewer than the routed tokens); the run
  ``deepseek-moe-16b-tokens`` widens the experts (``d_expert`` 256) so
  that training takes the path where the tokens move, with its
  gradients. At T 64 jamba's reference does not reach its pad-decay
  quirk (T > 128).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro_torch.configs import archs as torch_archs
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.interop import params_from_jax
from repro_torch.models import moe
from repro_torch.models.model import Model
from test_torch_train_gemma3 import jax_loss_and_grads, jax_params_from_port, rel
from torch_rank_workers import run_ranks, serve_runs, train_runs

CPU = torch.device("cpu")
SERVE = [(arch, arch, {}, 2, 4, 8, 4)
         for arch in ("yi-6b", "deepseek-moe-16b", "jamba-v0.1-52b")]
# one sequence: the decode rules split the cache's slots over both axes
# (long-context decode), and the partial softmax combines over both
SERVE.append(("yi-6b-batch1", "yi-6b", {}, 2, 1, 8, 4))
SERVE_BY_NAME = {r[0]: r for r in SERVE}
# name: (arch, the expert width, or None for the smoke preset's)
TRAINED = {"granite-moe-3b-a800m": ("granite-moe-3b-a800m", None),
           "deepseek-moe-16b": ("deepseek-moe-16b", None),
           "jamba-v0.1-52b": ("jamba-v0.1-52b", None),
           "deepseek-moe-16b-tokens": ("deepseek-moe-16b", 256)}
ARGV = ["--device", "cpu", "--batch", "4", "--seq", "64", "--steps", "2"]


def changes_of(name, archs=torch_archs):
    """The config changes of a trained run, for ``archs`` (the port's or
    the JAX package's configs)."""
    arch, d_expert = TRAINED[name]
    if d_expert is None:
        return {}
    moe = archs.get_config(arch, "smoke").moe
    return {"moe": dataclasses.replace(moe, d_expert=d_expert)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    return (serve_runs(0, 1, SERVE),
            run_ranks(serve_runs, 4, SERVE, store_dir=str(tmp), timeout=240)[0])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    runs = [(n, changes_of(n), ARGV + ["--arch", a])
            for n, (a, _) in TRAINED.items()]
    return (train_runs(0, 1, runs),
            run_ranks(train_runs, 4, [
                (n, c, argv + ["--model-parallel", "2"])
                for n, c, argv in runs], store_dir=str(tmp), timeout=300)[0])


@pytest.mark.parametrize("arch", [r[0] for r in SERVE])
def test_decode_on_the_mesh_gives_the_one_process_tokens(served, arch):
    one, four = served
    assert np.array_equal(four[arch][0], one[arch][0]), (four[arch][0],
                                                         one[arch][0])
    assert len(four[arch][1]) == len(one[arch][1]) == 4
    assert four[arch][0].shape == (SERVE_BY_NAME[arch][4], 4)


@pytest.mark.parametrize("arch", [r[0] for r in SERVE])
def test_logits_on_the_mesh_match_the_one_process_run(served, arch):
    one, four = served
    for got, want in zip(four[arch][1], one[arch][1]):
        assert got.shape == want.shape
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err < 1e-5, (arch, err)


@pytest.mark.parametrize("arch", list(TRAINED))
def test_moe_losses_match_the_one_process_run(trained, arch):
    one, four = trained
    losses, want = four[arch][0], one[arch][0]
    assert len(losses) == 2
    for got, ref in zip(losses, want):
        assert abs(got - ref) <= 1e-5 * abs(ref), (arch, losses, want)


@pytest.mark.parametrize("arch", list(TRAINED))
def test_moe_gradients_match_the_one_process_run(trained, arch):
    one, four = trained
    grads, want = four[arch][1], one[arch][1]
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert g.shape == want[n].shape, n
        assert rel(g, want[n]) < 1e-5, (arch, n, rel(g, want[n]))


@pytest.mark.parametrize("arch", list(TRAINED))
def test_moe_gradients_on_the_mesh_match_jax(trained, arch):
    name, (arch, _) = arch, TRAINED[arch]
    tcfg = dataclasses.replace(torch_archs.get_config(arch, "smoke"),
                               dtype="float32", **changes_of(name))
    jcfg = dataclasses.replace(jax_archs.get_config(arch, "smoke"),
                               dtype="float32",
                               **changes_of(name, jax_archs))
    model = Model(tcfg, CPU, trainable=True).init_weights(0)
    batch = SyntheticTokens(tcfg, DataConfig(batch=4, seq_len=64)).batch_at(0)
    (loss, _m), grads = jax_loss_and_grads(
        jax_params_from_port(model, jcfg), batch, jcfg)
    want = params_from_jax(jax.tree.map(np.asarray, grads), tcfg, CPU)
    losses, got = trained[1][name]
    assert abs(losses[0] - float(loss)) < 1e-5 * abs(float(loss))
    for n, g in got.items():
        assert rel(g, want[n]) < 1e-4, (name, n, rel(g, want[n]))


@pytest.mark.parametrize("name,tokens_move", [
    ("deepseek-moe-16b", False), ("jamba-v0.1-52b", False),
    ("deepseek-moe-16b-tokens", True)])
def test_training_takes_the_expected_moe_path(name, tokens_move):
    """Which path the trained runs take at B 4, T 64 (one group of 256
    tokens): the expert weights gathered, or the tokens moved."""
    cfg = dataclasses.replace(
        torch_archs.get_config(TRAINED[name][0], "smoke"),
        **changes_of(name))
    C = moe._group_capacity(256, cfg)
    assert moe._moves_tokens(1, C, cfg.d_model,
                             cfg.moe.d_expert) is tokens_move
