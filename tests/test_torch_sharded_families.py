"""Training and serving the vlm, the audio model and xLSTM across ranks.

Four gloo ranks on the CPU, one spawn (``family_runs``), rendezvous through
a ``FileStore`` under the test's temporary directory:

* training through ``launch.train.main`` (smoke, f32, B 4, T 32, 2 steps)
  of llama-3.2-vision-11b (gated cross-attention over the batch's encoder
  embeddings, every gate at 0.5: at its init of 0 the sublayer is zero)
  and musicgen-large (frames, 4 codebooks) at mesh (2,2), and of
  xlstm-125m at (2,2), (4,1) and (1,4). Each run is held to the
  one-process port run (losses within 1e-5 relative, the first step's
  gradients, gathered, within 1e-5 of max|ref|) and to ``jax.grad`` of the
  JAX package's loss on the same weights (1e-4, the bound of
  ``check_gradients``);
* greedy serving of the three (B 4, a prompt of 8, 4 new tokens; the
  audio model takes seeded frames, the vlm seeded encoder embeddings) at
  (2,2): prefill under the prefill rules, decode under the decode rules.
  The tokens equal the one-process run's and every step's logits lie
  within 1e-5 of max|ref|. The vlm's cross-attention cache is split over
  ``"model"`` (and the batch over ``"data"``), and decode attends it in
  place: ``tests/test_torch_dryrun_cross_jax.py`` checks that no
  collective moves a block of it;
* the vlm cell (B 4, T 64, gates 0.5) at (2,2) counted through one real
  step (``count_cost``, ``CommDebugMode``) and dry-run on a (2,2) fake
  mesh: the same FLOPs, collectives by opcode (counts and operand bytes)
  and flash calls by shape, its non-causal cross-attention calls among
  them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro_torch.configs import archs as torch_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.interop import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.models.model import Model
from test_torch_train_gemma3 import jax_loss_and_grads, rel
from test_torch_train_vlm import jax_params
from torch_rank_workers import (family_runs, run_ranks, serve_runs, set_gates,
                                train_runs)

CPU = torch.device("cpu")
VLM, AUDIO, XLSTM = "llama-3.2-vision-11b", "musicgen-large", "xlstm-125m"
GATE = 0.5
ARGV = ["--device", "cpu", "--batch", "4", "--seq", "32", "--steps", "2"]
# name: (arch, --model-parallel on 4 ranks)
TRAINED = {"vlm-2x2": (VLM, 2), "audio-2x2": (AUDIO, 2),
           "xlstm-2x2": (XLSTM, 2), "xlstm-4x1": (XLSTM, 1),
           "xlstm-1x4": (XLSTM, 4)}
SERVED = (VLM, AUDIO, XLSTM)
COUNTED = "vlm-2x2-counted"


def changes_of(arch):
    return {"cross_gate": GATE} if arch == VLM else {}


def vlm_counted_cfg():
    return dataclasses.replace(torch_archs.get_config(VLM, "smoke"),
                               dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's training and serving, the 4 ranks' training,
    serving and counted vlm step)."""
    trained = [(n, changes_of(a), ARGV + ["--arch", a, "--model-parallel",
                                          str(mp)])
               for n, (a, mp) in TRAINED.items()]
    served = [(a, a, changes_of(a), 2, 4, 8, 4) for a in SERVED]
    counted = [(COUNTED, vlm_counted_cfg(), 2, 4, 64, GATE)]
    four = run_ranks(family_runs, 4, trained, served, counted,
                     store_dir=str(tmp_path_factory.mktemp("families")),
                     timeout=300)[0]
    one_trained = train_runs(0, 1, [(a, changes_of(a), ARGV + ["--arch", a])
                                    for a in SERVED])
    return (one_trained, serve_runs(0, 1, served)), four


@pytest.fixture(scope="module")
def jax_grads():
    """(loss, gradients by port name) of ``jax.grad`` of the JAX loss on the
    port's seed-0 weights (gates at 0.5) and the launcher's first batch."""
    out = {}
    for arch in SERVED:
        tcfg = dataclasses.replace(torch_archs.get_config(arch, "smoke"),
                                   dtype="float32")
        jcfg = dataclasses.replace(jax_archs.get_config(arch, "smoke"),
                                   dtype="float32")
        model = Model(tcfg, CPU, trainable=True).init_weights(0)
        set_gates(model, changes_of(arch).get("cross_gate"))
        batch = SyntheticTokens(tcfg, DataConfig(batch=4, seq_len=32)
                                ).batch_at(0)
        (loss, _m), grads = jax_loss_and_grads(
            jax_params(model, jcfg), batch, jcfg)
        out[arch] = (float(loss), params_from_jax(
            jax.tree.map(np.asarray, grads), tcfg, CPU))
    return out


@pytest.mark.parametrize("name", list(TRAINED))
def test_losses_match_the_one_process_run(runs, name):
    (one, _), (four, _, _) = runs
    losses, want = four[name][0], one[TRAINED[name][0]][0]
    assert len(losses) == 2
    for got, ref in zip(losses, want):
        assert abs(got - ref) <= 1e-5 * abs(ref), (name, losses, want)


@pytest.mark.parametrize("name", list(TRAINED))
def test_first_gradients_match_the_one_process_run(runs, name):
    (one, _), (four, _, _) = runs
    grads, want = four[name][1], one[TRAINED[name][0]][1]
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert g.shape == want[n].shape, n        # gathered: global shapes
        assert rel(g, want[n]) < 1e-5, (name, n, rel(g, want[n]))


@pytest.mark.parametrize("name", list(TRAINED))
def test_first_gradients_match_jax(runs, jax_grads, name):
    loss, want = jax_grads[TRAINED[name][0]]
    losses, grads = runs[1][0][name]
    assert abs(losses[0] - loss) < 1e-5 * abs(loss)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert rel(g, want[n]) < 1e-4, (name, n, rel(g, want[n]))


def test_the_cross_gates_are_trained_at_half():
    """The vlm runs start from gates of 0.5 (tanh 0.46), so the cross
    sublayer and its gradients are not zero."""
    model = Model(torch_archs.get_config(VLM, "smoke"), CPU,
                  trainable=True).init_weights(0)
    set_gates(model, GATE)
    gates = [p for n, p in model.named_parameters() if n.endswith(".gate")]
    assert gates and all(float(p) == GATE for p in gates)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_on_the_mesh_gives_the_one_process_tokens(runs, arch):
    (_, one), (_, four, _) = runs
    assert np.array_equal(four[arch][0], one[arch][0]), (four[arch][0],
                                                         one[arch][0])
    assert len(four[arch][1]) == len(one[arch][1]) == 4
    ncb = torch_archs.get_config(arch, "smoke").n_codebooks
    assert four[arch][0].shape == (4, 4 * ncb)


@pytest.mark.parametrize("arch", SERVED)
def test_logits_on_the_mesh_match_the_one_process_run(runs, arch):
    (_, one), (_, four, _) = runs
    for got, want in zip(four[arch][1], one[arch][1]):
        assert got.shape == want.shape
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err < 1e-5, (arch, err)


def test_the_vlm_cross_cache_is_split_over_the_model_axis(runs):
    """At (2,2) under the decode rules the cross cache (B, N, K, D) is split
    over ``"data"`` by its batch and over ``"model"`` by its N slots."""
    (_, one), (_, four, _) = runs
    assert one[VLM][2] is None                     # plain tensors
    assert four[VLM][2] == "(Shard(dim=0), Shard(dim=1))"
    assert four[AUDIO][2] is None and four[XLSTM][2] is None


@pytest.fixture(scope="module")
def vlm_dry():
    return dryrun.run_cell(VLM, "train_4k", mesh_shape=(2, 2), device="cpu",
                           cfg=vlm_counted_cfg(),
                           shape=ShapeConfig("t", 64, 4, "train"),
                           save=False, verbose=False)


def test_the_vlm_dry_run_predicts_the_real_steps_flops(runs, vlm_dry):
    real = runs[1][2][COUNTED]
    assert vlm_dry["ok"] and vlm_dry["mesh"] == "2x2"
    assert vlm_dry["walker"]["flops_per_device"] == real["flops"]


def test_the_vlm_dry_run_predicts_the_real_steps_collectives(runs, vlm_dry):
    real = runs[1][2][COUNTED]
    got = {k: {"count": d["count"], "operand_bytes": d["operand_bytes"]}
           for k, d in vlm_dry["collectives_unscaled"]["by_opcode"].items()}
    assert got == real["collectives"]
    assert {k: d["count"] for k, d in got.items()} == real["comm_counts"]
    assert got


def test_the_vlm_dry_run_predicts_the_real_steps_flash_calls(runs, vlm_dry):
    """5 self-attention layers, the last with a cross-attention sublayer,
    full remat: the forward twice and each backward kernel once a layer
    and a sublayer, the cross ones non-causal at T 64 against N 32."""
    real = runs[1][2][COUNTED]
    assert vlm_dry["flash_launches_by_shape"] == real["by_shape"]
    assert real["by_shape"] == {
        "fwd/16/causal": 10, "dq/16/causal": 5, "dkv/16/causal": 5,
        "fwd/16/non-causal": 2, "dq/16/non-causal": 1,
        "dkv/16/non-causal": 1}
