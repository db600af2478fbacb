"""Step functions: train, eval, prefill and greedy decode (port of
``repro.train.step``).

The training step differentiates the model with autograd, where the JAX
package uses ``jax.value_and_grad``: gradients land in each parameter's
``.grad`` (f32, as the master weights) and stay there after the step, and
:func:`repro_torch.optim.adamw.apply_updates` then updates the weights in
place. While a ``torch.profiler`` runs, the step's forward, backward and
update are ``record_function`` spans (``train/forward``, ``train/backward``,
``train/update``), so a device trace splits the step by phase.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.regions import profiler_span
from ..models.model import Cache, Model
from ..optim import adamw
from .losses import chunked_ce_loss


def _loss(model: Model, tokens: torch.Tensor, labels: torch.Tensor,
          cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX ``loss_fn``: chunked CE on the train forward plus the MoE
    aux loss. The forward raises for models with mamba or moe layers,
    which do not train yet, so the aux is 0 on every model that trains."""
    hidden, aux = model(tokens, mode="train")
    lm_head = model.lm_head.to(model.compute_dtype)
    loss, metrics = chunked_ce_loss(hidden, lm_head, labels, cfg)
    return loss + aux[0], dict(metrics, moe_aux=aux[0],
                               moe_load_balance=aux[1])


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1):
    """Training step; ``microbatches > 1`` accumulates gradients over
    batch slices, dividing peak activation memory by N (the update runs
    once, in f32). The step's loss is the mean over microbatches; the
    other loss metrics are the last microbatch's, as in the JAX scan."""

    def train_step(model: Model, opt_state: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, object]:
        """Update ``model`` and ``opt_state`` in place; return the metrics
        (device scalars, and ``lr`` a float)."""
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} "
                             "microbatches")
        tokens = batch["tokens"].split(B // microbatches)
        labels = batch["labels"].split(B // microbatches)
        loss_sum = torch.zeros((), device=batch["tokens"].device)
        for tok, lab in zip(tokens, labels):
            with profiler_span("train/forward"):
                loss, metrics = _loss(model, tok, lab, cfg)
            with profiler_span("train/backward"):
                loss.backward()
            loss_sum = loss_sum + loss.detach()
        with profiler_span("train/update"):
            if microbatches > 1:
                for p in params.values():
                    p.grad.div_(microbatches)
            metrics = {k: v.detach() for k, v in metrics.items()}
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
            loss, metrics = _loss(model, batch["tokens"], batch["labels"], cfg)
        metrics["loss"] = loss
        return metrics

    return eval_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model: Model, batch, caches: Cache) -> torch.Tensor:
        """Prefill ``batch["tokens"]`` (B, P) into ``caches``; returns the
        last position's logits (B, n_codebooks, Vp) f32."""
        hidden, _aux = model(batch["tokens"], caches, mode="prefill")
        return model.logits(hidden[:, -1])

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model: Model, caches: Cache, batch, pos: int):
        """Greedy step: returns (logits, next_token (B, n_codebooks) int32)."""
        logits = model.decode_step(batch["tokens"], pos, caches)
        return logits, logits.argmax(dim=-1).to(torch.int32)

    return decode_step
