"""Training and serving musicgen-large (frame embeddings in, 4 codebooks
out) in the port against the JAX package.

The smoke preset raised to 2 layers (gelu, H = K = 4, head dim 16) in f32,
with no embedding table: the model takes frames (B, T, E) and its labels
are (B, T, 4). Weights are drawn by the port's seeded init and carried into
the JAX tree, batches made with numpy from a seed, as in
``tests/test_torch_train_vlm.py``, whose helpers this file shares. Held to
the JAX package: the gradients of one train step against
``jax.value_and_grad`` (max|err| / max|ref| below 1e-4) at T 24 and 40; the
losses over three AdamW steps against the jitted JAX step (rtol 1e-4); the
prefill logits (1e-4) and decode logits (1e-3) of every codebook; and
``remat="dots"`` against ``"full"`` and JAX's ``"dots"``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import train
from repro_torch.launch.train import to_device
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step
from test_torch_train_gemma3 import NO_UPDATE
from test_torch_train_vlm import (CPU, batch_np, check_gradients,
                                  check_prefill_and_decode, check_three_steps,
                                  models)

ARCH = "musicgen-large"


def audio(**changes):
    return models(ARCH, n_layers=2, **changes)


def test_audio_model_takes_frames_and_has_no_embedding():
    _, params, tcfg, model = audio()
    assert tcfg.input_mode == "frames" and tcfg.n_codebooks == 4
    assert "embed" not in dict(model.named_parameters())
    assert "embed" not in params
    assert model.lm_head.shape == (tcfg.d_model, 4 * tcfg.padded_vocab_size)
    frames = torch.randn(2, 8, tcfg.d_model, dtype=torch.float64)
    x = model.embed_inputs(frames)
    assert x.dtype == torch.float32 and torch.equal(x, frames.float())


@pytest.mark.parametrize("T", [24, 40])
def test_audio_gradients_match_jax(T):
    jcfg, params, tcfg, model = audio()
    batch = batch_np(tcfg, 2, T, seed=T)
    assert batch["labels"].shape == (2, T, 4) and "tokens" not in batch
    check_gradients(jcfg, params, tcfg, model, batch)


def test_audio_losses_over_three_steps_match_jax():
    check_three_steps(*audio(), B=2, T=40)


def test_audio_prefill_and_decode_match_jax():
    check_prefill_and_decode(*audio())


def test_audio_dots_remat_matches_full_and_jax():
    jcfg, params, tcfg, model = audio(remat="dots")
    batch = batch_np(tcfg, 2, 40, seed=11)
    dots = check_gradients(jcfg, params, tcfg, model, batch)
    _, _, _, full = audio(remat="full")
    make_train_step(tcfg, NO_UPDATE)(
        full, adamw.init_state(dict(full.named_parameters())),
        to_device(batch, CPU))
    for name, p in full.named_parameters():
        assert torch.allclose(dots[name], p.grad, rtol=1e-5, atol=1e-7), name


def test_audio_microbatches_split_frames_and_labels():
    # two microbatches of 2 give the mean of the two halves' gradients
    _, _, tcfg, model = audio()
    batch = to_device(batch_np(tcfg, 4, 24, seed=5), CPU)
    params = dict(model.named_parameters())
    make_train_step(tcfg, NO_UPDATE, microbatches=2)(
        model, adamw.init_state(params), batch)
    two = {n: p.grad.clone() for n, p in params.items()}
    halves = []
    for sl in (slice(0, 2), slice(2, 4)):
        make_train_step(tcfg, NO_UPDATE)(
            model, adamw.init_state(params),
            {k: v[sl] for k, v in batch.items()})
        halves.append({n: p.grad.clone() for n, p in params.items()})
    for n, g in two.items():
        assert torch.allclose(g, (halves[0][n] + halves[1][n]) / 2,
                              rtol=1e-5, atol=1e-7), n


def test_audio_cpu_training_counts_no_kernel_launch():
    before = dict(flash_attention.launches_by_shape)
    losses, stats = train.main([
        "--device", "cpu", "--arch", ARCH, "--preset", "smoke",
        "--steps", "2", "--batch", "2", "--seq", "32", "--layers", "2"])
    assert stats["layers"] == 2
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert stats["launches_by_shape"] == [{}, {}]
    assert flash_attention.launches_by_shape == before
