"""Step functions: train, eval, prefill and greedy decode (port of
``repro.train.step``).

The training step differentiates the model with autograd, where the JAX
package uses ``jax.value_and_grad``: gradients land in each parameter's
``.grad`` (f32, as the master weights) and stay there after the step, and
:func:`repro_torch.optim.adamw.apply_updates` then updates the weights in
place. A batch is a dict as in the JAX package: ``tokens`` (B, T) or,
for a ``frames`` model, ``frames`` (B, T, E); ``encoder_embeddings`` (B,
N, E) for a vlm model; ``labels`` (B, T), or (B, T, n_codebooks). While a
``torch.profiler`` runs, the step's forward, backward and
update are ``record_function`` spans (``train/forward``, ``train/backward``,
``train/update``), so a device trace splits the step by phase.

:class:`CapturedDecode` is the counterpart of the JAX serve loop's
``jax.jit(make_decode_step(cfg), donate_argnums=(1,))``: one decode step
and its argmax captured once into a CUDA graph over caches written in
place, then replayed at every position.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.regions import profiler_span
from ..models.model import Cache, Model
from ..optim import adamw
from ..sharding.rules import constrain, unshard
from .losses import chunked_ce_loss


def model_inputs(batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(tokens or frames, encoder embeddings or None) of a batch."""
    inputs = batch["frames"] if "frames" in batch else batch["tokens"]
    return inputs, batch.get("encoder_embeddings")


def _loss(model: Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX ``loss_fn``: chunked CE on the train forward plus the MoE
    aux loss (``aux[0]``: the router load-balance and z losses, weighted
    and summed over the MoE layers; 0 for a model without them)."""
    inputs, enc = model_inputs(batch)
    hidden, aux = model(inputs, mode="train", enc=enc)
    lm_head = model.lm_head.to(model.compute_dtype)
    loss, metrics = chunked_ce_loss(hidden, lm_head, batch["labels"], cfg)
    # under a mesh the loss is summed over the batch shards: replicate it,
    # so every rank's backward starts from the same total
    return constrain(loss + aux[0], ()), dict(metrics, moe_aux=aux[0],
                                              moe_load_balance=aux[1])


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1):
    """Training step; ``microbatches > 1`` accumulates gradients over
    batch slices (every entry of the batch split along B), dividing peak
    activation memory by N (the update runs once, in f32). The step's loss is the mean over microbatches; the
    other loss metrics are the last microbatch's, as in the JAX scan."""

    def train_step(model: Model, opt_state: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, object]:
        """Update ``model`` and ``opt_state`` in place; return the metrics
        (device scalars, and ``lr`` a float)."""
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        B = batch["labels"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} "
                             "microbatches")
        # under a mesh each microbatch is split over the batch axes again
        parts = {k: [constrain(x, ("batch",) + (None,) * (x.dim() - 1))
                     for x in v.split(B // microbatches)]
                 if microbatches > 1 else [v] for k, v in batch.items()}
        loss_sum = torch.zeros((), device=batch["labels"].device)
        for i in range(microbatches):
            with profiler_span("train/forward"):
                loss, metrics = _loss(model, {k: v[i] for k, v in
                                              parts.items()}, cfg)
            with profiler_span("train/backward"):
                loss.backward()
            loss_sum = loss_sum + unshard(loss.detach())
        with profiler_span("train/update"):
            if microbatches > 1:
                for p in params.values():
                    p.grad.div_(microbatches)
            metrics = {k: unshard(v.detach()) for k, v in metrics.items()}
            metrics.update(adamw.apply_updates(
                params, {n: p.grad for n, p in params.items()}, opt_state,
                opt_cfg))
        metrics["loss"] = loss_sum / microbatches
        return metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    def eval_step(model: Model, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, metrics = _loss(model, batch, cfg)
        metrics["loss"] = loss
        return metrics

    return eval_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model: Model, batch, caches: Cache) -> torch.Tensor:
        """Prefill ``batch`` (tokens (B, P) or frames (B, P, E), and a vlm
        model's encoder embeddings) into ``caches``; returns the last
        position's logits (B, n_codebooks, Vp) f32."""
        inputs, enc = model_inputs(batch)
        hidden, _aux = model(inputs, caches, mode="prefill", enc=enc)
        return model.logits(hidden[:, -1])

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model: Model, caches: Cache, batch, pos: int):
        """Greedy step of ``batch`` (tokens (B, 1) or frames (B, 1, E)):
        returns (logits, next_token (B, n_codebooks) int32)."""
        logits = model.decode_step(model_inputs(batch)[0], pos, caches)
        return logits, logits.argmax(dim=-1).to(torch.int32)

    return decode_step


# eager steps before a capture: the first initializes lazily (cuBLAS
# handles and workspaces), the second runs as the graph will
_WARMUP_STEPS = 2


class CapturedDecode:
    """A greedy decode step of ``model`` over ``caches`` for ``batch``
    sequences, captured once into a ``torch.cuda.CUDAGraph`` and replayed
    at every position.

    The graph reads two static input buffers, ``tokens`` (B, 1) int32 and
    ``pos``, a 0-d int32 tensor on the card, and writes two static output
    buffers, ``logits`` and ``next_token`` (B, n_codebooks) int32. A call
    copies its token and position into the inputs and replays the graph,
    which runs the same kernels as an eager step, on the caller's current
    stream; it returns the output buffers themselves, which the next call
    overwrites: a caller that keeps a token clones it.

    The warm-up steps before the capture write slot 0 of every attention
    cache and step every recurrent state, so capture before the prefill,
    which overwrites what they wrote. A model on the CPU raises: there
    decode runs eagerly (:func:`make_decode_step`). A failed capture
    raises; nothing falls back to eager decode.
    """

    def __init__(self, model: Model, caches: Cache, batch: int):
        device = model.device
        if device.type != "cuda":
            raise ValueError(
                f"a captured decode step needs a model on a CUDA card, not "
                f"{device}; on the CPU decode runs eagerly "
                "(make_decode_step)")
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        self.pos = torch.zeros((), dtype=torch.int32, device=device)

        def step():
            logits = model.decode_step(self.tokens, self.pos, caches)
            return logits, logits.argmax(dim=-1).to(torch.int32)

        with torch.no_grad():
            # warm-up on a side stream (lazy initialization, cuBLAS
            # workspaces), as graph capture requires
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_STEPS):
                    step()
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: threads that touch no CUDA state (a telemetry
            # poller, its HTTP server) may run during the capture
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.logits, self.next_token = step()

    def __call__(self, tokens: torch.Tensor, pos
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of ``tokens`` (B, 1) at position ``pos`` (an int, or
        a 0-d tensor): returns the (logits, next_token) output buffers."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        return self.logits, self.next_token

