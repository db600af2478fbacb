"""Serving step functions: prefill and greedy decode (the serving half of
``repro.train.step``; the training step comes with a later slice)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models.model import Cache, Model


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model: Model, batch, caches: Cache) -> torch.Tensor:
        """Prefill ``batch["tokens"]`` (B, P) into ``caches``; returns the
        last position's logits (B, n_codebooks, Vp) f32."""
        hidden = model(batch["tokens"], caches, mode="prefill")
        return model.logits(hidden[:, -1])

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model: Model, caches: Cache, batch, pos: int):
        """Greedy step: returns (logits, next_token (B, n_codebooks) int32)."""
        logits = model.decode_step(batch["tokens"], pos, caches)
        return logits, logits.argmax(dim=-1).to(torch.int32)

    return decode_step
