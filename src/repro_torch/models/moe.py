"""Mixture-of-Experts FFN: top-k routing with capacity-bounded dispatch
(port of ``repro.models.moe``).

Tokens go in groups of ``token_group`` (the last group padded with zero
rows, which route and count like the JAX package's). Within a group each
(token, choice) takes the next slot of its expert, in the flattened
(token, choice) order; a choice past the expert's capacity C is dropped.
Dispatch gathers token rows into (experts, C, d_model) slots and gathers
the outputs back, with no one-hot einsum. Experts past ``n_experts`` are
dead pads: the router masks them.

Two behaviours of the JAX package are kept on purpose:

- ``jax.lax.top_k`` breaks ties toward the lower expert index; a stable
  descending sort does the same here (zero pad rows tie on every expert).
- The JAX scatter of token ids into slots sends each dropped choice to
  slot C-1 with the zero row, and on XLA's CPU the last write wins. So an
  expert that drops any choice computes its slot C-1 on the zero row, and
  the token kept there gets that expert's zero output while its gate
  stays. The port writes the kept slots, then sets slot C-1 of every
  expert that dropped a choice to the zero row: the same result, with no
  scatter of duplicate indices, whose order torch leaves undefined.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from .common import ParamSpec, activation


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.moe
    E, F = cfg.d_model, m.d_expert
    Ne = cfg.padded_n_experts       # dead pad experts: router masks them
    specs = {
        "router": ParamSpec((E, Ne), ("embed", "experts"), dtype=torch.float32),
        "wg": ParamSpec((Ne, E, F), ("experts", "embed", "expert_mlp")),
        "wi": ParamSpec((Ne, E, F), ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((Ne, F, E), ("experts", "expert_mlp", "embed"),
                        init="scaled", scale=1.0),
    }
    if m.n_shared:
        Fs = F * m.n_shared
        specs["shared_wg"] = ParamSpec((E, Fs), ("embed", "mlp"))
        specs["shared_wi"] = ParamSpec((E, Fs), ("embed", "mlp"))
        specs["shared_wo"] = ParamSpec((Fs, E), ("mlp", "embed"),
                                       init="scaled", scale=1.0)
    return specs


def _route(logits: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, indices) (g, k): the top-k logits, ties to the lower index,
    and a softmax over the k selected."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return torch.softmax(vals, dim=-1), idx


def _group_capacity(group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = math.ceil(group * m.top_k / m.n_experts * m.capacity_factor)
    return max(m.top_k, min(group, -(-c // 4) * 4))   # mult of 4, sane bounds


def _one_group(params, xt: torch.Tensor, cfg: ModelConfig, C: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token group xt (g, E): returns (y (g, E), [load balance, router
    z, dropped fraction] f32)."""
    m = cfg.moe
    act = activation(cfg.act)
    g, E = xt.shape
    Ne, k, n_real = cfg.padded_n_experts, m.top_k, m.n_experts
    logits = xt.float() @ params["router"]                       # (g, Ne)
    if Ne != n_real:
        dead = torch.arange(Ne, device=xt.device) >= n_real
        logits = logits.masked_fill(dead, -1e30)
    gates, idx = _route(logits, k)                               # (g, k)
    # slot of each (token, choice) inside its expert: exclusive cumsum
    flat_oh = torch.nn.functional.one_hot(idx.reshape(-1), Ne)   # (g*k, Ne)
    pos = ((flat_oh.cumsum(0) - flat_oh) * flat_oh).sum(-1)      # (g*k,)
    keep = pos < C
    e_idx = idx.reshape(-1)
    tok_id = torch.arange(g, device=xt.device).repeat_interleave(k)
    # slot -> token row; row g is the zero row. Kept choices own distinct
    # slots; dropped ones write to one spare slot past the end (all with
    # the value g), so no slot that is kept gets two writes. Scatters, not
    # boolean indexing: nothing waits for the card.
    spare = Ne * C
    slot_tok = torch.full((spare + 1,), g, dtype=torch.long, device=xt.device)
    slot_tok.scatter_(0, torch.where(keep, e_idx * C + pos, spare),
                      torch.where(keep, tok_id, g))
    slot_tok = slot_tok[:spare].view(Ne, C)
    dropped_any = torch.zeros(Ne + 1, dtype=torch.bool, device=xt.device)
    dropped_any.scatter_(0, torch.where(keep, Ne, e_idx),
                         torch.ones_like(keep))
    slot_tok[:, C - 1] = torch.where(dropped_any[:Ne], g, slot_tok[:, C - 1])
    xt_pad = torch.cat([xt, xt.new_zeros((1, E))], dim=0)
    xe = xt_pad[slot_tok]                                        # (Ne, C, E)
    h = act(torch.bmm(xe, params["wg"])) * torch.bmm(xe, params["wi"])
    ye = torch.bmm(h, params["wo"])                              # (Ne, C, E)
    out_pair = ye[idx, pos.clamp(max=C - 1).view(g, k)]          # (g, k, E)
    w = (gates * keep.view(g, k)).to(ye.dtype)
    yt = torch.einsum("gk,gke->ge", w, out_pair)
    # aux stats
    frac_tokens = flat_oh.sum(0).float() / (g * k)
    probs = torch.softmax(logits, dim=-1).mean(0)
    lb = (frac_tokens * probs).sum() * n_real
    z = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - keep.float().mean()
    return yt, torch.stack([lb, z, dropped])


def moe_apply(
    params,
    x: torch.Tensor,                                  # (B, T, E)
    cfg: ModelConfig,
    token_group: int = 4096,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (y (B, T, E), aux): ``moe_load_balance``, ``moe_router_z``
    and ``moe_dropped_frac`` (each the mean over groups) and
    ``moe_aux_loss``."""
    m = cfg.moe
    act = activation(cfg.act)
    B, T, E = x.shape
    flat = x.reshape(B * T, E)
    n_tok = flat.shape[0]
    group = min(token_group, n_tok)
    pad = -n_tok % group
    xg = torch.nn.functional.pad(flat, (0, 0, 0, pad)) if pad else flat
    C = _group_capacity(group, cfg)
    ys, stats = [], []
    for xt in xg.split(group):
        yt, st = _one_group(params, xt, cfg, C)
        ys.append(yt)
        stats.append(st)
    y = torch.cat(ys)[:n_tok].view(B, T, E)
    lb, z, dropped = torch.stack(stats).mean(0)
    if m.n_shared:
        hs = act(flat @ params["shared_wg"]) * (flat @ params["shared_wi"])
        y = y + (hs @ params["shared_wo"]).view(B, T, E)
    aux = {
        "moe_load_balance": lb,
        "moe_router_z": z,
        "moe_dropped_frac": dropped,
        "moe_aux_loss": m.router_aux_weight * lb + m.router_z_weight * z,
    }
    return y, aux
