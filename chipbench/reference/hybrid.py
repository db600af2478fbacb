"""The hybrid decoder (jamba): attention and Mamba-1 mixers, MLP and
top-k mixture-of-experts FFNs, in the pattern the configuration gives
(:func:`chipbench.cells.dims`), in plain f32 PyTorch. An MoE layer adds
its shared experts (one gated FFN of ``d_shared``, always active) to the
routed ones.

The experts follow the configuration's stated capacity: tokens go in
groups of ``token_group`` rows (a prefill's rows across its batch, in
(row, position) order, the last group padded with zero rows; each decode
position's rows a group of their own); in a group every (token, choice)
takes the next slot of its expert in (token, choice) order, and a choice
past the capacity C is dropped. An expert that drops any choice gives
its slot C-1 nothing, as the port's last-write scatter does. Gates are a
softmax over the k chosen logits, ties broken toward the lower expert.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .common import (Spec, attention_layer, attention_specs, embed, linear,
                     logits, mlp, mlp_specs, norm_specs, rms_norm, top_specs)


def read(c: Dict, d: Dict) -> None:
    """The file keys only this family has, into ``d``: the Mamba-1
    mixer's sizes, where the file states ``mamba_d_state``."""
    if "mamba_d_state" in c:
        d.update(d_inner=c["mamba_expand"] * d["d_model"],
                 d_state=c["mamba_d_state"], d_conv=c["mamba_d_conv"],
                 dt_rank=c.get("mamba_dt_rank", math.ceil(d["d_model"] / 16)))


def port_fields(d: Dict) -> Dict:
    """The port's ``ModelConfig`` fields that those keys imply: its
    ``mamba`` (as :func:`chipbench.cells.port_view` states it)."""
    if "d_state" not in d:
        return {}
    return {"mamba": {k: d[k] for k in ("d_inner", "d_state", "d_conv",
                                        "dt_rank")}}


def specs(d: Dict) -> Dict[str, Spec]:
    """Every parameter by name, layer by layer as ``d["layers"]`` has
    them."""
    out = top_specs(d)
    E = d["d_model"]
    for l, (mixer, ffn) in enumerate(d["layers"]):
        p = f"layers.{l}."
        out.update(norm_specs(d, p))
        if mixer == "attn":
            out.update(attention_specs(d, p))
        else:
            dI, N, dC, R = d["d_inner"], d["d_state"], d["d_conv"], d["dt_rank"]
            out[p + "mixer.in_proj"] = ((E, 2 * dI), "normal", 0.02)
            out[p + "mixer.conv_w"] = ((dC, dI), "normal", 0.1)
            out[p + "mixer.conv_b"] = ((dI,), "normal", 0.1)
            out[p + "mixer.x_proj"] = ((dI, R + 2 * N), "normal", 0.02)
            out[p + "mixer.dt_w"] = ((R, dI), "normal", 0.02)
            out[p + "mixer.dt_b"] = ((dI,), "around", -4.6)
            out[p + "mixer.A_log"] = ((dI, N), "log_range", 0.0)
            out[p + "mixer.D"] = ((dI,), "around", 1.0)
            out[p + "mixer.out_proj"] = ((dI, E), "fan_in", 1.0)
        if ffn == "mlp":
            out.update(mlp_specs(d, p + "ffn.", d["d_ff"]))
        else:
            Ne, F = d["padded_experts"], d["d_expert"]
            out[p + "ffn.router"] = ((E, Ne), "normal", 0.02)
            out[p + "ffn.wg"] = ((Ne, E, F), "normal", 0.02)
            out[p + "ffn.wi"] = ((Ne, E, F), "normal", 0.02)
            out[p + "ffn.wo"] = ((Ne, F, E), "fan_in", 1.0)
            if d["n_shared"]:
                out.update(mlp_specs(d, p + "ffn.shared_", d["d_shared"]))
    return out


def scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
         chunk: int = 16) -> torch.Tensor:
    """y (B, T, dI) of the selective scan h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t, y_t = h_t · C_t + D x_t from a zero state, in chunks of
    time in closed form."""
    Bsz, T, dI = x.shape
    h = torch.zeros((Bsz, dI, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        S = (dt[:, s:e, :, None] * A).cumsum(1)                 # (B, c, dI, N)
        u = (dt[:, s:e] * x[:, s:e])[..., None] * Bc[:, s:e, None, :]
        c = e - s
        later = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
        diff = S[:, :, None] - S[:, None, :]                     # (B, t, j, dI, N)
        W = torch.exp(diff.masked_fill(~later[None, :, :, None, None],
                                       float("-inf")))
        H = torch.exp(S) * h[:, None] + torch.einsum("btjdn,bjdn->btdn", W, u)
        ys.append((H * Cc[:, s:e, None, :]).sum(-1) + D * x[:, s:e])
        h = H[:, -1]
    return torch.cat(ys, dim=1)


def mamba_layer(d: dict, w, p: str, h: torch.Tensor,
                quant: Optional[str] = None) -> torch.Tensor:
    """The Mamba-1 mixer of weights ``p + "mixer.*"`` on h (B, T, E)."""
    T = h.shape[1]
    dI, N, dC, R = d["d_inner"], d["d_state"], d["d_conv"], d["dt_rank"]
    xin, z = linear(h, w(p + "mixer.in_proj"), quant).chunk(2, dim=-1)
    cw = w(p + "mixer.conv_w")                                   # (dC, dI)
    xp = F.pad(xin, (0, 0, dC - 1, 0))
    conv = sum(xp[:, i:i + T] * cw[i] for i in range(dC))
    xc = F.silu(conv + w(p + "mixer.conv_b"))
    dt_low, Bc, Cc = linear(xc, w(p + "mixer.x_proj"), quant).split(
        [R, N, N], dim=-1)
    dt = F.softplus(linear(dt_low, w(p + "mixer.dt_w"), quant)
                    + w(p + "mixer.dt_b"))
    A = -torch.exp(w(p + "mixer.A_log"))
    y = scan(xc, dt, A, Bc, Cc, w(p + "mixer.D"))
    return linear(y * F.silu(z), w(p + "mixer.out_proj"), quant)


def capacity(d: dict, group: int) -> int:
    c = math.ceil(group * d["top_k"] / d["n_experts"] * d["capacity_factor"])
    return max(d["top_k"], min(group, -(-c // 4) * 4))


def groups(B: int, T: int, prefill_len: int, token_group: int
           ) -> List[torch.Tensor]:
    """The routing groups of h (B, T, E) flattened to rows b·T + t: a
    prefill's rows (t < prefill_len) in (b, t) order, cut into groups of
    ``min(token_group, B·prefill_len)`` (-1: a zero pad row), then one
    group a later position, its B rows."""
    rows = torch.arange(B * T).view(B, T)
    pre = rows[:, :prefill_len].reshape(-1)
    out = []
    if pre.numel():
        g = min(token_group, pre.numel())
        pad = -pre.numel() % g
        pre = torch.cat([pre, torch.full((pad,), -1, dtype=pre.dtype)])
        out += list(pre.view(-1, g))
    out += [rows[:, t] for t in range(prefill_len, T)]
    return out


def route(d: dict, router: torch.Tensor, x: torch.Tensor,
          group: torch.Tensor):
    """(expert, gate) (g, k) of each row of a group (gate 0 for a choice
    dropped or left without its slot), for rows ``group`` of x (n, E),
    -1 a zero row."""
    k, n = d["top_k"], d["n_experts"]
    xg = torch.where(group[:, None] >= 0, x[group.clamp_min(0)],
                     torch.zeros((), device=x.device))
    lg = xg @ router[:, :n]
    vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :k], dim=-1)
    idx = idx[:, :k]
    C = capacity(d, group.numel())
    flat = idx.reshape(-1)
    oh = F.one_hot(flat, n)
    pos = ((oh.cumsum(0) - oh) * oh).sum(-1)                    # slot in expert
    keep = pos < C
    dropped = torch.zeros(n, dtype=torch.bool, device=x.device)
    dropped[flat[~keep]] = True
    keep &= ~((pos == C - 1) & dropped[flat])
    return idx, gates * keep.view(idx.shape)


def moe_layer(d: dict, w, p: str, h: torch.Tensor, prefill_len: int,
              quant: Optional[str] = None) -> torch.Tensor:
    """The MoE FFN of weights ``p + "ffn.*"`` on h (B, T, E)."""
    B, T, E = h.shape
    x = h.reshape(B * T, E)
    router = w(p + "ffn.router")
    gate = torch.zeros((B * T, d["n_experts"]), device=h.device)
    for group in groups(B, T, prefill_len, d["token_group"]):
        group = group.to(h.device)
        idx, g = route(d, router, x, group)
        real = group >= 0
        gate[group[real, None], idx[real]] += g[real]
    y = torch.zeros_like(x)
    wg, wi, wo = (w(p + f"ffn.{n}") for n in ("wg", "wi", "wo"))
    for e in range(d["n_experts"]):
        rows = torch.nonzero(gate[:, e]).view(-1)
        if rows.numel():
            out = mlp(x[rows], wg[e], wi[e], wo[e], quant, d["act"])
            y.index_add_(0, rows, gate[rows, e, None] * out)
    if d["n_shared"]:
        y = y + mlp(x, *(w(p + f"ffn.shared_{n}") for n in ("wg", "wi", "wo")),
                    quant, d["act"])
    return y.view(B, T, E)


def serve_logits(d: dict, w, tokens: torch.Tensor, first_out: int,
                 prefill_len: int, quant: Optional[str] = None
                 ) -> torch.Tensor:
    """Logits (B, L - first_out, V) at positions first_out..L-1 of tokens
    (B, L), whose first ``prefill_len`` positions were one prefill and
    the rest decode steps of the batch."""
    x = embed(d, w, tokens)
    for l, (mixer, ffn) in enumerate(d["layers"]):
        p = f"layers.{l}."
        h = rms_norm(x, w(p + "norm_mixer"), d["norm_eps"])
        x = x + (attention_layer(d, w, p, h, quant, d["windows"][l])
                 if mixer == "attn" else mamba_layer(d, w, p, h, quant))
        h = rms_norm(x, w(p + "norm_ffn"), d["norm_eps"])
        if ffn == "mlp":
            x = x + mlp(h, w(p + "ffn.wg"), w(p + "ffn.wi"), w(p + "ffn.wo"),
                        quant, d["act"])
        else:
            x = x + moe_layer(d, w, p, h, prefill_len, quant)
    return logits(d, w, x[:, first_out:], quant)
