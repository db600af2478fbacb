"""The dense decoder (yi-6b): pre-norm GQA attention with RoPE and a
gated MLP, in plain f32 PyTorch; each layer global or windowed, with
qk-norm where the configuration states ``"qk_norm": true``.

:func:`serve_logits` runs B sequences whole, layer by layer (each
layer's weights drawn once), and returns the logits at the positions
asked for: a prefill followed by decode through a cache gives the same
numbers. :func:`train_loss` is the training loss (cross-entropy plus
1e-4 times the mean squared log-partition, the port's z-loss), with each
layer recomputed in the backward.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .common import (Spec, attention_layer, attention_specs, embed, logits,
                     mlp, mlp_specs, norm_specs, rms_norm, top_specs)


def read(c: Dict, d: Dict) -> None:
    """The file keys only this family has, into ``d``: ``qk_norm``
    (default false)."""
    d["qk_norm"] = bool(c.get("qk_norm", False))


def port_fields(d: Dict) -> Dict:
    """The port's ``ModelConfig`` fields that those keys imply."""
    return {"qk_norm": d["qk_norm"]}


def specs(d: Dict) -> Dict[str, Spec]:
    """Every parameter by name: attention and an MLP in every layer."""
    out = top_specs(d)
    for l, layer in enumerate(d["layers"]):
        if layer != ("attn", "mlp"):
            raise SystemExit(f"{d['name']}: layer {l} is {layer}; the dense "
                             f"reference has attention and an MLP alone")
        p = f"layers.{l}."
        out.update(norm_specs(d, p))
        out.update(attention_specs(d, p))
        out.update(mlp_specs(d, p + "ffn.", d["d_ff"]))
    return out


def _layer(d: dict, w, l: int, x: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    p = f"layers.{l}."
    x = x + attention_layer(d, w, p, rms_norm(x, w(p + "norm_mixer"),
                                              d["norm_eps"]), quant,
                            d["windows"][l])
    h = rms_norm(x, w(p + "norm_ffn"), d["norm_eps"])
    return x + mlp(h, w(p + "ffn.wg"), w(p + "ffn.wi"), w(p + "ffn.wo"), quant,
                   d["act"])


def serve_logits(d: dict, w, tokens: torch.Tensor, first_out: int,
                 prefill_len: int, quant: Optional[str] = None
                 ) -> torch.Tensor:
    """Logits (B, L - first_out, V) at positions first_out..L-1 of tokens
    (B, L). ``prefill_len`` does not change a dense model's numbers."""
    x = embed(d, w, tokens)
    for l in range(d["n_layers"]):
        x = _layer(d, w, l, x, quant)
    return logits(d, w, x[:, first_out:], quant)


def train_loss(d: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
               labels: torch.Tensor, quant: Optional[str] = None,
               chunk: int = 256, z_weight: float = 1e-4) -> torch.Tensor:
    """Mean cross-entropy of ``labels`` plus ``z_weight`` times the mean
    squared logsumexp, differentiable in ``params``."""
    w = params.__getitem__
    x = embed(d, w, tokens)
    for l in range(d["n_layers"]):
        x = checkpoint(_layer, d, w, l, x, quant, use_reentrant=False)
    def sums(xc, lab):
        lg = logits(d, w, xc, quant)
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, lab[..., None])[..., 0]
        return (lse - ll).sum(), (lse * lse).sum()

    nll = zsum = 0.0
    T = tokens.shape[1]
    for s in range(0, T, chunk):
        n, z = checkpoint(sums, x[:, s:s + chunk], labels[:, s:s + chunk],
                          use_reentrant=False)
        nll, zsum = nll + n, zsum + z
    count = labels.numel()
    return nll / count + z_weight * zsum / count
