"""xLSTM blocks: mLSTM (parallel, matrix memory) and sLSTM (recurrent)
(port of ``repro.models.xlstm``).

mLSTM runs in the chunked, stabilized linear-attention form with
exponential input gates and sigmoid-in-log-space forget gates, carrying
the (C, n, m) state across chunks (C: (B, H, D, D) matrix memory; n: the
normalizer; m: the log stabilizer); decode is one step of the same
recurrence. sLSTM is a true recurrence over time with exponential gating,
per-head block-diagonal recurrent weights and the (h, c, n, m) stabilized
state: its prefill is a loop of T steps, as the JAX package's
``lax.scan``. The JAX package runs that scan inside a ``shard_map`` over
the data axes when a mesh is set and marks the sequence boundaries with
sharding constraints; on one device both are the plain scan, which is
what the port runs.

No Pallas kernel exists for either mixer (the JAX package leaves them to
XLA in jnp), so the port runs them in plain PyTorch. Mixed-dtype products
of the JAX package (an f32 state against bf16 recurrent weights) promote
to f32 there; here the weight is cast to f32 first, the same arithmetic.

Per xLSTM-125M, blocks are pre-up-projection: the config's d_ff = 0 means
the feed-forward lives inside the blocks (mLSTM pf = 2, sLSTM MLP pf =
4/3), so these layers have ``ffn="none"``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import ParamSpec, activation, rms_norm
from .mamba import _causal_conv

State = Tuple[torch.Tensor, ...]


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    H = cfg.n_heads
    return d_inner, H, d_inner // H


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    E = cfg.d_model
    dI, H, _ = _mlstm_dims(cfg)
    dC = cfg.xlstm.conv_kernel
    return {
        "up_proj": ParamSpec((E, 2 * dI), ("embed", "inner")),
        "conv_w": ParamSpec((dC, dI), (None, "inner"), init="normal", scale=0.1),
        "conv_b": ParamSpec((dI,), ("inner",), init="zeros"),
        "wq": ParamSpec((dI, dI), ("inner", None)),
        "wk": ParamSpec((dI, dI), ("inner", None)),
        "wv": ParamSpec((dI, dI), ("inner", None)),
        "w_if": ParamSpec((dI, 2 * H), ("inner", None), dtype=torch.float32),
        "b_if": ParamSpec((2 * H,), (None,), init="zeros", dtype=torch.float32),
        "skip": ParamSpec((dI,), (None,), init="ones"),
        "out_norm": ParamSpec((dI,), (None,), init="zeros"),
        "down_proj": ParamSpec((dI, E), (None, "embed"), init="scaled", scale=1.0),
    }


def _mlstm_chunk(q, k, v, ilog, flog, state: State
                 ) -> Tuple[torch.Tensor, State]:
    """One chunk of the stabilized chunked mLSTM.

    q, k, v: (B, Q, H, D); ilog, flog: (B, Q, H) log-space gates; state:
    (C (B, H, D, D), n (B, H, D), m (B, H)). Returns (h (B, Q, H, D) f32,
    the state at the end of the chunk)."""
    Q, D = q.shape[1], q.shape[3]
    C, n, m = state
    Fc = torch.cumsum(flog, dim=1)                   # (B, Q, H) inclusive
    Ftot = Fc[:, -1]                                 # (B, H)
    # log weight of source s -> target t (s <= t): F_t - F_s + i_s
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + ilog[:, None, :, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    logD = logD.masked_fill(~tri[None, :, :, None], float("-inf"))
    m_intra = logD.amax(dim=2)                       # (B, Q, H)
    m_inter = Fc + m[:, None, :]                     # (B, Q, H)
    m_new = torch.maximum(m_intra, m_inter).clamp_min(-1e30)
    Dmat = torch.exp(logD - m_new[:, :, None, :])    # (B, Q, Q, H)
    scale = 1.0 / math.sqrt(D)
    qs = q.float() * scale
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bthd,bshd->btsh", qs, kf) * Dmat
    intra = torch.einsum("btsh,bshd->bthd", scores, vf)
    inter_w = torch.exp(m_inter - m_new)             # (B, Q, H)
    inter = torch.einsum("bthd,bhde->bthe", qs, C) * inter_w[..., None]
    num = intra + inter
    qn = torch.einsum("bthd,bhd->bth", qs, n) * inter_w
    denom = scores.sum(dim=2) + qn                   # (B, Q, H)
    denom = torch.maximum(denom.abs(), torch.exp(-m_new))
    h = num / denom[..., None]                       # (B, Q, H, D)
    # the state at the end of the chunk
    src = Ftot[:, None, :] - Fc + ilog               # (B, Q, H)
    m_next = torch.maximum(Ftot + m, src.amax(dim=1))
    w_old = torch.exp(Ftot + m - m_next)             # (B, H)
    w_src = torch.exp(src - m_next[:, None, :])      # (B, Q, H)
    C_next = C * w_old[..., None, None] + torch.einsum(
        "bshd,bshe->bhde", kf * w_src[..., None], vf)
    n_next = n * w_old[..., None] + torch.einsum("bshd,bsh->bhd", kf, w_src)
    return h, (C_next, n_next, m_next)


def mlstm_apply(
    params,
    x: torch.Tensor,                                 # (B, T, E)
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]],
    mode: str = "prefill",                           # train | prefill | decode
) -> torch.Tensor:
    """Returns the mixer output (B, T, E). Prefill writes the state after
    the last prompt token and the conv tail into ``cache``; decode (T = 1)
    steps them, in place."""
    B, T, E = x.shape
    dI, H, Dh = _mlstm_dims(cfg)
    dC = cfg.xlstm.conv_kernel
    xm, z = (x @ params["up_proj"]).chunk(2, dim=-1)
    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError("decode takes one token and a cache")
        conv_tail = cache["conv"]
        xc = _causal_conv(xm, params["conv_w"], params["conv_b"],
                          tail=conv_tail)
    elif mode in ("train", "prefill"):
        xc = _causal_conv(xm, params["conv_w"], params["conv_b"])
    else:
        raise ValueError(f"unknown mode {mode!r}")
    xc = F.silu(xc)
    q = (xc @ params["wq"]).view(B, T, H, Dh)
    k = (xc @ params["wk"]).view(B, T, H, Dh)
    v = (xm @ params["wv"]).view(B, T, H, Dh)
    gates = xc.float() @ params["w_if"] + params["b_if"]
    ilog, fpre = gates.view(B, T, 2, H).unbind(dim=2)   # (B, T, H) each
    flog = F.logsigmoid(fpre)

    if mode == "decode":
        C, n, m = cache["C"], cache["n"], cache["m"]
        m_next = torch.maximum(flog[:, 0] + m, ilog[:, 0])
        w_old = torch.exp(flog[:, 0] + m - m_next)
        w_new = torch.exp(ilog[:, 0] - m_next)
        kf, vf = k[:, 0].float(), v[:, 0].float()
        C_next = C * w_old[..., None, None] + torch.einsum(
            "bhd,bhe->bhde", kf * w_new[..., None], vf)
        n_next = n * w_old[..., None] + kf * w_new[..., None]
        qf = q[:, 0].float() / math.sqrt(Dh)
        num = torch.einsum("bhd,bhde->bhe", qf, C_next)
        denom = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_next).abs(),
                              torch.exp(-m_next))
        h = (num / denom[..., None])[:, None]        # (B, 1, H, Dh)
        cache["conv"].copy_(torch.cat([conv_tail[:, 1:], xm], dim=1))
        cache["C"].copy_(C_next)
        cache["n"].copy_(n_next)
        cache["m"].copy_(m_next)
    else:
        chunk = min(cfg.xlstm.chunk, T)
        pad = -T % chunk
        # pad steps add nothing (input gate -1e30) and forget nothing
        # (log forget gate 0), so the state after them is the last token's
        qp, kp, vp = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        ip = F.pad(ilog, (0, 0, 0, pad), value=-1e30)
        fp = F.pad(flog, (0, 0, 0, pad))
        state = (torch.zeros((B, H, Dh, Dh), dtype=torch.float32,
                             device=x.device),
                 torch.zeros((B, H, Dh), dtype=torch.float32, device=x.device),
                 torch.full((B, H), -1e30, dtype=torch.float32,
                            device=x.device))
        hs = []
        for c0 in range(0, T + pad, chunk):
            sl = slice(c0, c0 + chunk)
            h_c, state = _mlstm_chunk(qp[:, sl], kp[:, sl], vp[:, sl],
                                      ip[:, sl], fp[:, sl], state)
            hs.append(h_c)
        h = torch.cat(hs, dim=1)[:, :T]
        if mode == "prefill" and cache is not None:
            for name, st in zip(("C", "n", "m"), state):
                cache[name].copy_(st)
            cache["conv"].copy_(F.pad(xm, (0, 0, dC - 1, 0))[:, -(dC - 1):])

    hflat = h.to(x.dtype).reshape(B, T, dI)
    hflat = rms_norm(hflat, params["out_norm"], cfg.norm_eps)
    y = hflat + params["skip"].to(xc.dtype) * xc
    return (y * F.silu(z)) @ params["down_proj"]


def mlstm_alloc_cache(cfg: ModelConfig, batch: int, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """Zero decode cache of one mLSTM mixer (``mlstm_cache_specs``): C, n,
    m in f32 (m at 0, as the JAX package's zero caches) and the conv tail
    in cfg.dtype."""
    dI, H, Dh = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, Dh, Dh), **f32),
        "n": torch.zeros((batch, H, Dh), **f32),
        "m": torch.zeros((batch, H), **f32),
        "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, dI),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    E, H = cfg.d_model, cfg.n_heads
    Dh = E // H
    Fw = int(E * cfg.xlstm.proj_factor_slstm)
    return {
        "w_gates": ParamSpec((E, 4 * E), ("embed", None)),
        "r_gates": ParamSpec((H, Dh, 4 * Dh), (None, None, None),
                             init="scaled", scale=1.0),
        "b_gates": ParamSpec((4 * E,), (None,), init="zeros"),
        "group_norm": ParamSpec((E,), (None,), init="zeros"),
        "mlp_wi": ParamSpec((E, Fw), ("embed", "mlp")),
        "mlp_wg": ParamSpec((E, Fw), ("embed", "mlp")),
        "mlp_wo": ParamSpec((Fw, E), ("mlp", "embed"), init="scaled", scale=1.0),
    }


def _slstm_cell(state: State, wx: torch.Tensor, r_gates: torch.Tensor,
                H: int, Dh: int) -> State:
    """state: (h, c, n, m) each (B, H, Dh) f32; wx: (B, 4E) f32
    preactivations; r_gates (H, Dh, 4Dh) f32."""
    h, c, n, m = state
    B = h.shape[0]
    rx = torch.einsum("bhd,hde->bhe", h, r_gates)    # (B, H, 4Dh)
    pre = wx.view(B, H, 4 * Dh) + rx
    zi, ii, fi, oi = pre.chunk(4, dim=-1)            # (B, H, Dh)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    flog = F.logsigmoid(fi)
    m_new = torch.maximum(flog + m, ii)
    i_w = torch.exp(ii - m_new)
    f_w = torch.exp(flog + m - m_new)
    c_new = f_w * c + i_w * zt
    n_new = torch.maximum(f_w * n + i_w, torch.exp(-m_new))
    return ot * c_new / n_new, c_new, n_new, m_new


def slstm_apply(
    params,
    x: torch.Tensor,                                 # (B, T, E)
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]],
    mode: str = "prefill",                           # train | prefill | decode
) -> torch.Tensor:
    """The sLSTM block (the cell, a group norm and its own MLP, with the
    MLP's residual); returns (B, T, E). Prefill steps the cell over the
    prompt, one step a position, and writes the final state into
    ``cache``; decode (T = 1) steps it once, in place."""
    B, T, E = x.shape
    H = cfg.n_heads
    Dh = E // H
    act = activation(cfg.act)
    wx = (x @ params["w_gates"] + params["b_gates"].to(x.dtype)).float()
    r_gates = params["r_gates"].float()
    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError("decode takes one token and a cache")
        state = _slstm_cell((cache["h"], cache["c"], cache["n"], cache["m"]),
                            wx[:, 0], r_gates, H, Dh)
        hs = state[0][:, None]                       # (B, 1, H, Dh)
        for name, st in zip(("h", "c", "n", "m"), state):
            cache[name].copy_(st)
    elif mode in ("train", "prefill"):
        zero = torch.zeros((B, H, Dh), dtype=torch.float32, device=x.device)
        state = (zero, zero, torch.ones_like(zero), zero)
        steps = []
        for t in range(T):
            state = _slstm_cell(state, wx[:, t], r_gates, H, Dh)
            steps.append(state[0])
        hs = torch.stack(steps, dim=1)               # (B, T, H, Dh)
        if mode == "prefill" and cache is not None:
            for name, st in zip(("h", "c", "n", "m"), state):
                cache[name].copy_(st)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = hs.reshape(B, T, E).to(x.dtype)
    y = rms_norm(y, params["group_norm"], cfg.norm_eps)
    hmlp = act(y @ params["mlp_wg"]) * (y @ params["mlp_wi"])
    return y + hmlp @ params["mlp_wo"]


def slstm_alloc_cache(cfg: ModelConfig, batch: int, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """Zero decode cache of one sLSTM mixer (``slstm_cache_specs``): h, c,
    n, m, each (B, H, Dh) f32."""
    H = cfg.n_heads
    Dh = cfg.d_model // H
    return {name: torch.zeros((batch, H, Dh), dtype=torch.float32,
                              device=device) for name in ("h", "c", "n", "m")}
