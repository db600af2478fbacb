"""Mixture-of-Experts FFN: top-k routing with capacity-bounded dispatch
(port of ``repro.models.moe``).

Tokens go in groups of ``token_group`` (the last group padded with zero
rows, which route and count like the JAX package's); every group routes
on its own, in one batch of ops over the groups, and each expert runs
once on its slots of every group. Within a group each
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

On a mesh (DTensor x and weights) routing is the one-process routing,
and the experts run on their ranks along ``"model"`` (:func:`_sharded`):
where a rank's routed tokens are fewer than its experts' weights, as in
every decode step, the weights stay in their stored placement and the
tokens move to them (:func:`_sharded_tokens`); otherwise, as at a
training step's many tokens, the experts are gathered over the FSDP axis.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..core.regions import profiler_span
from ..sharding.rules import constrain, shard_block
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
    """(gates, indices) (..., k): the top-k logits, ties to the lower
    index, and a softmax over the k selected."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    return torch.softmax(vals, dim=-1), idx


def _group_capacity(group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = math.ceil(group * m.top_k / m.n_experts * m.capacity_factor)
    return max(m.top_k, min(group, -(-c // 4) * 4))   # mult of 4, sane bounds


def _groups(x: torch.Tensor, group: int) -> torch.Tensor:
    """Rows (n, E) as token groups (n_groups, group, E), the last padded
    with zero rows."""
    pad = -x.shape[0] % group
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x.view(-1, group, x.shape[-1])


def _route_groups(router: torch.Tensor, xg: torch.Tensor, cfg: ModelConfig,
                  C: int) -> Dict[str, torch.Tensor]:
    """Routing of token groups xg (n, g, E), each on its own: ``gates``,
    ``idx``, ``pos`` (each (n, g, k): the softmax over the k chosen, the
    experts, each choice's slot in its expert), ``keep`` (n, g*k),
    ``slot_tok`` (n, Ne, C): the token row of every slot (row g is the
    zero row), and ``stats`` (n, 3): [load balance, router z, dropped
    fraction] f32 of each group."""
    m = cfg.moe
    n, g, E = xg.shape
    Ne, k, n_real = cfg.padded_n_experts, m.top_k, m.n_experts
    logits = xg.float() @ router                              # (n, g, Ne)
    if Ne != n_real:
        dead = torch.arange(Ne, device=xg.device) >= n_real
        logits = logits.masked_fill(dead, -1e30)
    gates, idx = _route(logits, k)                            # (n, g, k)
    # slot of each (token, choice) inside its expert: exclusive cumsum
    flat_oh = torch.nn.functional.one_hot(idx.reshape(n, g * k), Ne)
    pos = ((flat_oh.cumsum(1) - flat_oh) * flat_oh).sum(-1)   # (n, g*k)
    keep = pos < C
    e_idx = idx.reshape(n, g * k)
    tok_id = torch.arange(g, device=xg.device).repeat_interleave(k)
    # slot -> token row; row g is the zero row. Kept choices own distinct
    # slots; dropped ones write to one spare slot past the end (all with
    # the value g), so no slot that is kept gets two writes. Scatters, not
    # boolean indexing: nothing waits for the card.
    spare = Ne * C
    slot_tok = torch.full((n, spare + 1), g, dtype=torch.long,
                          device=xg.device)
    slot_tok.scatter_(1, torch.where(keep, e_idx * C + pos, spare),
                      torch.where(keep, tok_id, g))
    slot_tok = slot_tok[:, :spare].view(n, Ne, C)
    dropped_any = torch.zeros((n, Ne + 1), dtype=torch.bool, device=xg.device)
    dropped_any.scatter_(1, torch.where(keep, Ne, e_idx),
                         torch.ones_like(keep))
    slot_tok[:, :, C - 1] = torch.where(dropped_any[:, :Ne], g,
                                        slot_tok[:, :, C - 1])
    # aux stats
    frac_tokens = flat_oh.sum(1).float() / (g * k)
    probs = torch.softmax(logits, dim=-1).mean(1)
    lb = (frac_tokens * probs).sum(-1) * n_real
    z = torch.logsumexp(logits, dim=-1).square().mean(-1)
    dropped = 1.0 - keep.float().mean(-1)
    return {"gates": gates, "idx": idx, "pos": pos.view(n, g, k),
            "keep": keep, "slot_tok": slot_tok,
            "stats": torch.stack([lb, z, dropped], dim=-1)}


def _dispatch(xg: torch.Tensor, slot_tok: torch.Tensor) -> torch.Tensor:
    """The slots' token rows (ne, n*C, E) of groups xg (n, g, E), from
    ``slot_tok`` (n, ne, C) (row g: the zero row)."""
    n, g, E = xg.shape
    ne, C = slot_tok.shape[1:]
    rows = torch.arange(n, device=xg.device)
    xg_pad = torch.cat([xg, xg.new_zeros((n, 1, E))], dim=1)
    xe = xg_pad[rows[:, None, None], slot_tok]                # (n, ne, C, E)
    return xe.transpose(0, 1).reshape(ne, n * C, E)


def _combine(ye: torch.Tensor, r: Dict[str, torch.Tensor], C: int,
             experts: Optional[slice]) -> torch.Tensor:
    """y (n, g, E) of the expert outputs ``ye`` (ne, n*C, E), each token's
    choices weighted by their gates; with ``experts`` (the slice of the
    expert index ``ye`` holds) only those experts' part of the sum."""
    idx, pos = r["idx"], r["pos"]
    n, g, _k = idx.shape
    ne, E = ye.shape[0], ye.shape[-1]
    ye = ye.view(ne, n, C, E).transpose(0, 1)
    rows = torch.arange(n, device=ye.device)
    w = r["gates"] * r["keep"].view(n, g, -1)
    at = pos.clamp(max=C - 1)
    if experts is None:
        out_pair = ye[rows[:, None, None], idx, at]           # (n, g, k, E)
    else:
        mine = (idx >= experts.start) & (idx < experts.stop)
        local = (idx - experts.start).clamp(0, ne - 1)
        out_pair = ye[rows[:, None, None], local, at]
        w = w * mine
    return torch.einsum("ngk,ngke->nge", w.to(ye.dtype), out_pair)


def _experts_groups(params, xg: torch.Tensor, r: Dict[str, torch.Tensor],
                    cfg: ModelConfig, C: int, experts: Optional[slice] = None
                    ) -> torch.Tensor:
    """The expert FFNs of routed groups xg (n, g, E): y (n, g, E). Each
    expert runs once on its slots of every group. With ``experts`` (a
    slice of the expert index) only those experts run, on the expert
    weights' local block (its first expert is the slice's start), and y
    is their part of the sum over the k choices."""
    slot_tok = r["slot_tok"]
    if experts is not None:
        slot_tok = slot_tok[:, experts]
    ye = _expert_ffn(params, _dispatch(xg, slot_tok), cfg)
    return _combine(ye, r, C, experts)


def _expert_ffn(params, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert's gated FFN on its slots xe (ne, slots, E)."""
    act = activation(cfg.act)
    h = act(torch.bmm(xe, params["wg"])) * torch.bmm(xe, params["wi"])
    return torch.bmm(h, params["wo"])


def moe_apply(
    params,
    x: torch.Tensor,                                  # (B, T, E)
    cfg: ModelConfig,
    token_group: int = 4096,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (y (B, T, E), aux): ``moe_load_balance``, ``moe_router_z``
    and ``moe_dropped_frac`` (each the mean over groups) and
    ``moe_aux_loss``.

    While a ``torch.profiler`` runs, the one-process path's phases are
    ``record_function`` spans: ``moe/route``, ``moe/dispatch``,
    ``moe/experts`` (the three expert GEMMs and the activation),
    ``moe/combine``, and ``moe/shared`` where the layer has shared
    experts."""
    m = cfg.moe
    act = activation(cfg.act)
    B, T, E = x.shape
    flat = x.reshape(B * T, E)
    if isinstance(x, DTensor):
        y, lb, z, dropped = _sharded(params, x, cfg, token_group)
    else:
        group = min(token_group, B * T)
        C = _group_capacity(group, cfg)
        xg = _groups(flat, group)
        with profiler_span("moe/route"):
            r = _route_groups(params["router"], xg, cfg, C)
        with profiler_span("moe/dispatch"):
            xe = _dispatch(xg, r["slot_tok"])
        with profiler_span("moe/experts"):
            ye = _expert_ffn(params, xe, cfg)
        with profiler_span("moe/combine"):
            y = _combine(ye, r, C, None).reshape(-1, E)
        y = y[:B * T].view(B, T, E)
        lb, z, dropped = r["stats"].mean(0)
    if m.n_shared:
        with profiler_span("moe/shared"):
            hs = act(flat @ params["shared_wg"]) * (flat @ params["shared_wi"])
            y = y + (hs @ params["shared_wo"]).view(B, T, E)
    aux = {
        "moe_load_balance": lb,
        "moe_router_z": z,
        "moe_dropped_frac": dropped,
        "moe_aux_loss": m.router_aux_weight * lb + m.router_z_weight * z,
    }
    return y, aux


def _moves_tokens(n_groups: int, C: int, E: int, F: int) -> bool:
    """Whether the experts stay where they are stored and the tokens move
    (:func:`_sharded_tokens`): per expert, moving the tokens reduces its
    (n_groups·C, 2F) products over the FSDP axis and returns its
    (n_groups·C, E) outputs, where gathering the expert moves its 3·E·F
    weights. Fewer routed token elements than weight elements: always in
    decode; at a training step's many tokens the weights are fewer."""
    return n_groups * C * (2 * F + E) < 3 * E * F


def _sharded(params, x: DTensor, cfg: ModelConfig, token_group: int):
    """The MoE FFN of DTensor x (B, T, E) on a mesh: (y (B, T, E), load
    balance, router z, dropped fraction).

    The sequence is gathered first (token groups cut the flattened (B, T)
    dimension; the reference's SP boundary). Routing is the one-process
    routing, capacity and the last-slot quirk included. When a rank's
    routed tokens are fewer than its experts' weights
    (:func:`_moves_tokens`), the weights stay in their stored placement
    and the tokens move (:func:`_sharded_tokens`). Otherwise each rank
    routes its batch shard's groups with the whole router, when the groups
    fall on batch shards (the rows of a shard fill whole groups); where a
    group spans the batch, the batch is gathered and every rank routes
    every group. The experts are then gathered over the FSDP axis and
    split over ``"model"``, and, when the batch was gathered, over the
    batch axes too where they divide the experts: each rank runs its own
    experts on its tokens (``local_map``), and the outputs combine as a
    ``Partial`` sum over the expert axes (reduced back onto the batch
    shards when the batch was gathered). Routing and the experts are
    separate ``local_map`` calls, so that the router's gradient is the
    gates' (a partial sum over the expert axes) plus the aux losses' (the
    same on every rank)."""
    mesh = x.device_mesh
    B, T, E = x.shape
    Ne = cfg.padded_n_experts
    x = constrain(x, ("batch", None, None))
    group = min(token_group, B * T)
    n_groups = -(-B * T // group)
    C = _group_capacity(group, cfg)
    if _moves_tokens(n_groups, C, E, cfg.moe.d_expert):
        return _sharded_tokens(params, x, cfg, group, C, n_groups)
    _lo, Bl, split = shard_block(x, 0)
    e_dims = [d for d, p in enumerate(params["wg"].placements)
              if p == Shard(0)]
    gathered = []
    if (Bl * T) % group:
        # every rank routes every group; the batch axes split the experts
        # further where they divide them, so no expert runs twice
        x = x.redistribute(mesh, [Replicate() if p == Shard(0) else p
                                  for p in x.placements])
        gathered = list(split)
        n = math.prod(mesh.size(d) for d in e_dims)
        for d in gathered:
            if Ne % (n * mesh.size(d)) == 0:
                e_dims.append(d)
                n *= mesh.size(d)
        e_dims.sort()
    batch_dims = [d for d, p in enumerate(x.placements) if p == Shard(0)]
    routing, stats = _route_sharded(params["router"], x, cfg, group, C)
    w_pl = [Shard(0) if d in e_dims else Replicate()
            for d in range(mesh.ndim)]
    weights = [params[n].redistribute(mesh, w_pl) for n in ("wg", "wi", "wo")]
    e_lo, e_n, _ = shard_block(weights[0], 0)
    experts = slice(e_lo, e_lo + e_n) if e_dims else None

    def run(xl, gates, idx, pos, keep, slot_tok, wg, wi, wo):
        y = _experts_groups({"wg": wg, "wi": wi, "wo": wo},
                            _groups(xl.reshape(-1, E), group),
                            dict(zip(_KEYS, (gates, idx, pos, keep,
                                             slot_tok))), cfg, C, experts)
        return y.reshape(-1, E)[:xl.shape[0] * T].view(xl.shape[0], T, E)

    part = [Partial() if d in e_dims else Replicate()
            for d in range(mesh.ndim)]
    x_out = [Shard(0) if d in batch_dims else part[d]
             for d in range(mesh.ndim)]
    w_grad = [Shard(0) if d in e_dims else
              Partial() if d in batch_dims else Replicate()
              for d in range(mesh.ndim)]
    route_pl = [r.placements for r in routing]
    y = local_map(
        run, out_placements=x_out,
        in_placements=(x.placements, *route_pl, *[w_pl] * 3),
        in_grad_placements=(x_out, x_out, *route_pl[1:], *[w_grad] * 3),
        device_mesh=mesh)(x, *routing, *weights)
    if gathered:
        # back to the batch shards: a reduce-scatter over the batch axes
        y = y.redistribute(mesh, [Shard(0) if d in gathered else p
                                  for d, p in enumerate(y.placements)])
    return (y, *_stats(stats, n_groups))


_KEYS = ("gates", "idx", "pos", "keep", "slot_tok")


def _route_sharded(router: DTensor, x: DTensor, cfg: ModelConfig, group: int,
                   C: int):
    """(the routing of :func:`_route_groups` as DTensors (``_KEYS``), the
    summed stats) of DTensor x (B, T, E), each rank routing the groups of
    its batch shard (every group when x is replicated) with the whole
    router."""
    mesh = x.device_mesh
    E = x.shape[-1]
    batch_dims = [d for d, p in enumerate(x.placements) if p == Shard(0)]
    rep = [Replicate()] * mesh.ndim

    def by_batch(on_batch, other=Replicate()):
        return [on_batch if d in batch_dims else other
                for d in range(mesh.ndim)]

    def route(xl, rt):
        r = _route_groups(rt, _groups(xl.reshape(-1, E), group), cfg, C)
        return (*(r[k] for k in _KEYS), r["stats"].sum(0))

    *routing, stats = local_map(
        route, out_placements=(*[by_batch(Shard(0))] * len(_KEYS),
                               by_batch(Partial())),
        in_placements=(x.placements, rep),
        in_grad_placements=(x.placements, by_batch(Partial())),
        device_mesh=mesh)(x, router.redistribute(mesh, rep))
    return routing, stats


def _stats(stats: DTensor, n_groups: int):
    """(load balance, router z, dropped fraction): the means over groups."""
    mesh = stats.device_mesh
    return (stats.redistribute(mesh, [Replicate()] * mesh.ndim)
            / n_groups).unbind(0)


def _sharded_tokens(params, x: DTensor, cfg: ModelConfig, group: int, C: int,
                    n_groups: int):
    """:func:`_sharded`'s path where the tokens move: the expert weights
    stay in their stored placement, the experts split over ``"model"``
    and ``embed`` over ``"data"`` (the FSDP axis), and no weight is
    redistributed. The batch is gathered and every rank routes every group
    (the one-process routing). Each rank contracts its experts' slots'
    ``embed`` block with its local ``wg`` and ``wi`` block; the partial
    (experts_local, n·C, 2F) products are summed over the FSDP axis; ``wo``
    writes the rank's ``embed`` block of its experts' outputs, weighted
    and summed over the choices; an all-to-all over the FSDP axis trades
    those ``embed`` blocks of the whole batch for every column of the
    rank's batch shard, and the sum over the expert axes (``Partial``)
    finishes y."""
    mesh = x.device_mesh
    B, T, E = x.shape
    F = cfg.moe.d_expert
    act = activation(cfg.act)
    wg, wi, wo = (params[n] for n in ("wg", "wi", "wo"))
    e_dims = [d for d, p in enumerate(wg.placements) if p == Shard(0)]
    emb_dims = [d for d, p in enumerate(wg.placements) if p == Shard(1)]
    if (wi.placements != wg.placements or list(wo.placements) != [
            Shard(2) if d in emb_dims else p
            for d, p in enumerate(wg.placements)] or len(emb_dims) > 1):
        raise ValueError(f"expert weights placed {wg.placements}, "
                         f"{wi.placements}, {wo.placements}")
    target = list(x.placements)
    x = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    routing, stats = _route_sharded(params["router"], x, cfg, group, C)
    e_lo, e_n, _ = shard_block(wg, 0)
    experts = slice(e_lo, e_lo + e_n)

    def pl(e, emb, other=Replicate()):
        return [e if d in e_dims else emb if d in emb_dims else other
                for d in range(mesh.ndim)]

    def up(xl, slot_tok, wg, wi):
        xe = _dispatch(_groups(xl.reshape(-1, xl.shape[-1]), group),
                       slot_tok[:, experts])
        return torch.cat([torch.bmm(xe, wg), torch.bmm(xe, wi)], dim=-1)

    x_pl = pl(Replicate(), Shard(2))
    gi = local_map(
        up, out_placements=pl(Shard(0), Partial()),
        in_placements=(x_pl, routing[4].placements, wg.placements,
                       wi.placements),
        in_grad_placements=(pl(Partial(), Shard(2)), routing[4].placements,
                            wg.placements, wi.placements),
        device_mesh=mesh)(x.redistribute(mesh, x_pl), routing[4], wg, wi)
    gi = gi.redistribute(mesh, pl(Shard(0), Replicate()))

    to_batch = [d for d in emb_dims if target[d] == Shard(0)]

    def down(gi, gates, idx, pos, keep, wo):
        g, i = gi.split(F, dim=-1)
        ye = torch.bmm(act(g) * i, wo)
        r = dict(zip(_KEYS, (gates, idx, pos, keep)))
        y = _combine(ye, r, C, experts)
        y = y.reshape(-1, y.shape[-1])[:B * T].view(B, T, -1)
        for d in to_batch:
            y = _embed_to_batch(y, mesh, d)
        return y

    route_pl = [t.placements for t in routing[:4]]
    y = local_map(
        down,
        out_placements=pl(Partial(), Shard(0) if to_batch else Shard(2)),
        in_placements=(gi.placements, *route_pl, wo.placements),
        in_grad_placements=(pl(Shard(0), Partial()), pl(Partial(), Partial()),
                            *route_pl[1:], wo.placements),
        device_mesh=mesh)(gi, *routing[:4], wo)
    return (y.redistribute(mesh, target), *_stats(stats, n_groups))


def _embed_to_batch(y: torch.Tensor, mesh, d: int) -> torch.Tensor:
    """(B/D, T, D·E_l) of this rank's block ``y`` (B, T, E_l) of the
    columns, over mesh dimension ``d`` of size D: one all-to-all sends
    each rank its rows of the block."""
    import torch.distributed._functional_collectives as funcol

    Dn = mesh.size(d)
    B, T, El = y.shape
    out = funcol.all_to_all_single_autograd(
        y.reshape(Dn, B // Dn, T, El).contiguous(), None, None, (mesh, d))
    return out.permute(1, 2, 0, 3).reshape(B // Dn, T, Dn * El)
