"""The one generator of traffic: it reads a mix's parameters and makes
its requests or batches from the seed.

A serving mix (``"kind": "serve"``) is an open loop: bursts of ``burst``
requests, all of one prompt length, arrive every ``burst / rate_rps``
seconds from the window's start, their lengths cycling through
``prompt_lens`` in order; every seed gets the same lengths and arrivals,
and draws only the token ids. A training mix (``"kind": "train"``) is a
stream of (tokens, labels) batches from the bigram generator below, one
per step, every row different.

``SyntheticTokens`` is copied from ``src/repro_torch/data/pipeline.py``
at commit 5ccc2ae (without its region annotation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .weights import _key


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    arrival_s: float
    prompt_len: int


def schedule(mix: Dict, seconds: float) -> List[Request]:
    """Every request of a serving mix that arrives in [0, seconds)."""
    burst, rate = mix["burst"], mix["rate_rps"]
    lens = mix["prompt_lens"]
    out: List[Request] = []
    k = 0
    while k * burst / rate < seconds:
        for j in range(burst):
            out.append(Request(len(out), k * burst / rate, lens[k % len(lens)]))
        k += 1
    return out


def prompts(seed: int, batch_index: int, n: int, length: int, vocab: int,
            device: torch.device) -> torch.Tensor:
    """The (n, length) prompt token ids of one batch, drawn from the seed
    on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(_key(seed, f"prompts/{batch_index}"))
    return torch.randint(0, vocab, (n, length), generator=g, device=device)


class SyntheticTokens:
    """token[t] depends on token[t-1] through a fixed random bigram table,
    giving a learnable ~2.5-nat structure over the vocab."""

    def __init__(self, vocab_size: int, seed: int, batch: int, seq_len: int,
                 n_successors: int = 8):
        self.vocab_size, self.seed = vocab_size, seed
        self.batch, self.seq_len = batch, seq_len
        rng = np.random.default_rng(seed)
        V = vocab_size
        k = min(n_successors, V)
        self._succ = rng.integers(0, V, size=(V, k), dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, T = self.batch, self.seq_len
        V = self.vocab_size
        toks = np.empty((B, T + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        choices = rng.integers(0, self._succ.shape[1], size=(B, T))
        for t in range(T):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
