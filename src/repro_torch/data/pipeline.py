"""Deterministic, resumable synthetic data pipeline.

Every batch is a pure function of (seed, step), so a restart from a
checkpoint at step k reproduces the exact token stream with no iterator
state to persist — the preemption-safe pattern used by large-scale runs.
Tokens follow a Zipf-ish distribution with short-range structure so the
loss actually decreases (the e2e example trains on this).

A copy of ``repro.data.pipeline``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig
from ..core import regions


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    batch: int = 8
    seq_len: int = 512
    n_successors: int = 8     # branching factor of the bigram structure


class SyntheticTokens:
    """token[t] depends on token[t-1] through a fixed random bigram table,
    giving a learnable ~2.5-nat structure over the vocab."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        rng = np.random.default_rng(data.seed)
        V = cfg.vocab_size
        k = min(data.n_successors, V)
        self._succ = rng.integers(0, V, size=(V, k), dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        with regions.annotate("data/batch_at", category="data", step=step):
            d = self.data
            rng = np.random.default_rng((self.data.seed, step))
            B, T = d.batch, d.seq_len
            V = self.cfg.vocab_size
            toks = np.empty((B, T + 1), np.int32)
            toks[:, 0] = rng.integers(0, V, size=B)
            choices = rng.integers(0, self._succ.shape[1], size=(B, T))
            for t in range(T):
                toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
            batch: Dict[str, np.ndarray] = {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:].copy(),
            }
            if self.cfg.input_mode == "frames":
                rngf = np.random.default_rng((self.data.seed, step, 7))
                batch = {
                    "frames": rngf.standard_normal(
                        (B, T, self.cfg.d_model)).astype(np.float32),
                    "labels": np.stack(
                        [toks[:, 1:] % self.cfg.vocab_size]
                        * self.cfg.n_codebooks, axis=-1),
                }
            if self.cfg.input_mode == "tokens+image":
                rngi = np.random.default_rng((self.data.seed, step, 11))
                batch["encoder_embeddings"] = rngi.standard_normal(
                    (B, self.cfg.encoder_len, self.cfg.d_model)
                ).astype(np.float32) * 0.02
            return batch

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
