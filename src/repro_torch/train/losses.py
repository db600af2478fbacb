"""Chunked cross-entropy: never materializes (B, T, V) logits
(port of ``repro.train.losses``).

The loss walks over sequence chunks, computing (B, chunk, V) logits per
step. Each chunk runs under ``torch.utils.checkpoint``, as the JAX scan
body runs under ``jax.checkpoint``: only the chunk's inputs are kept, and
its logits are recomputed in the backward, so live logits stay bounded by
one chunk in the forward *and* the backward. At yi-6b's 64k vocab, B=4,
T=1024, that is 0.26 GB of f32 logits a chunk instead of 1 GB for the
sequence.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig

IGNORE = -100


def _chunk_sums(h: torch.Tensor, lm_head: torch.Tensor, lab: torch.Tensor,
                ncb: int, V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll sum, z sum) over the valid labels of one chunk."""
    B, c, _ = h.shape
    logits = (h @ lm_head).float().view(B, c, ncb, -1)
    Vp = logits.shape[-1]
    if Vp != V:
        logits = logits.masked_fill(torch.arange(Vp, device=h.device) >= V,
                                    -1e30)
    lse = torch.logsumexp(logits, dim=-1)                      # (B, c, ncb)
    safe = lab.clamp(0, V - 1)
    ll = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    valid = lab != IGNORE
    zero = torch.zeros((), device=h.device)
    nll = torch.where(valid, lse - ll, zero).sum()
    zsum = torch.where(valid, lse * lse, zero).sum()
    return nll, zsum


def chunked_ce_loss(
    hidden: torch.Tensor,              # (B, T, E)
    lm_head: torch.Tensor,             # (E, ncb * Vp)
    labels: torch.Tensor,              # (B, T) or (B, T, ncb) int
    cfg: ModelConfig,
    chunk: int = 256,
    z_weight: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over labels != IGNORE, plus
    ``z_weight`` times the mean squared logsumexp (z-loss). Returns
    (loss, {"ce", "z_loss", "tokens"}), all f32 scalars on the device."""
    B, T, E = hidden.shape
    ncb, V = cfg.n_codebooks, cfg.vocab_size
    if labels.dim() == 2:
        labels = labels[..., None]     # (B, T, 1)
    c = min(chunk, T)
    pad = -T % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, 0, 0, pad), value=IGNORE)
    nll = zsum = torch.zeros((), device=hidden.device)
    for i in range(0, T + pad, c):
        n, z = checkpoint(_chunk_sums, hidden[:, i:i + c], lm_head,
                          labels[:, i:i + c], ncb, V, use_reentrant=False)
        nll, zsum = nll + n, zsum + z
    denom = (labels != IGNORE).sum().clamp_min(1).float()
    ce = nll / denom
    z = zsum / denom
    return ce + z_weight * z, {"ce": ce, "z_loss": z, "tokens": denom}
