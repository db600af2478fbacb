"""xLSTM blocks: mLSTM (parallel, matrix memory) and sLSTM (recurrent)
(port of ``repro.models.xlstm``).

mLSTM runs in the chunked, stabilized linear-attention form with
exponential input gates and sigmoid-in-log-space forget gates, carrying
the (C, n, m) state across chunks (C: (B, H, D, D) matrix memory; n: the
normalizer; m: the log stabilizer); decode is one step of the same
recurrence. sLSTM is a true recurrence over time with exponential gating,
per-head block-diagonal recurrent weights and the (h, c, n, m) stabilized
state: its prefill is a loop of T steps, as the JAX package's
``lax.scan``.

On a mesh (DTensor weights and caches) the port follows the reference's
design: the sLSTM loop runs inside one ``local_map`` over the batch axes
(the reference's ``shard_map``), its recurrent weights' gradient summed
once at the boundary; the mLSTM's causal conv runs on each rank's
``"inner"`` channels (``mamba.sharded_conv``), its ``wq``/``wk``/``wv``
and gate projections are row-parallel over ``"inner"`` (the partial sums
all-reduced), and its log-space gates and chunk loop run in one
``local_map`` over the batch axes on replicated heads. Decode steps the
states over ``"batch"`` and, where the heads' axes divide the heads, over
``"heads"`` (each cell is per head; the reference's partitioner splits
the step so), and the conv tail over ``"inner"``, in place. On a (1,1)
mesh each path runs the plain path's helpers, so its bits are the plain
path's.

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

from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..sharding.rules import constrain
from .common import ParamSpec, activation, rms_norm
from .mamba import _conv, _tail, sharded_conv

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


def _mlstm_mix(q, k, v, gates, cache, mode: str, chunk: int
               ) -> Tuple[torch.Tensor, Optional[State]]:
    """(h (B, T, H, D) f32, the state after the last token, or None in
    decode) of q, k, v (B, T, H, D) and the gates' (B, T, 2H) f32
    preactivations: the log-space gates, then decode's one step of the
    recurrence against the cache's (C, n, m), stepped in place, or the
    chunk loop of train and prefill. Every op is per batch row: on a mesh
    each rank runs it on its own rows."""
    B, T, H, Dh = q.shape
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
        cache["C"].copy_(C_next)
        cache["n"].copy_(n_next)
        cache["m"].copy_(m_next)
        return (num / denom[..., None])[:, None], None   # (B, 1, H, Dh)
    chunk = min(chunk, T)
    pad = -T % chunk
    # pad steps add nothing (input gate -1e30) and forget nothing (log
    # forget gate 0), so the state after them is the last token's
    qp, kp, vp = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
    ip = F.pad(ilog, (0, 0, 0, pad), value=-1e30)
    fp = F.pad(flog, (0, 0, 0, pad))
    f32 = dict(dtype=torch.float32, device=q.device)
    state = (torch.zeros((B, H, Dh, Dh), **f32),
             torch.zeros((B, H, Dh), **f32),
             torch.full((B, H), -1e30, **f32))
    hs = []
    for c0 in range(0, T + pad, chunk):
        sl = slice(c0, c0 + chunk)
        h_c, state = _mlstm_chunk(qp[:, sl], kp[:, sl], vp[:, sl],
                                  ip[:, sl], fp[:, sl], state)
        hs.append(h_c)
    return torch.cat(hs, dim=1)[:, :T], state


def _mlstm_out(params, h: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """The mixer output (B, T, E) of the cell's h (B, T, H, D): normed, the
    skip of the conv output added, gated by SiLU(z), projected down. On a
    mesh the normed h goes to the channels' axes (a local slice of the
    replicated heads), so that the rest runs on each rank's channels and
    the down projection contracts them."""
    B, T = h.shape[:2]
    hflat = rms_norm(h.to(dtype).reshape(B, T, -1), params["out_norm"],
                     cfg.norm_eps)
    hflat = constrain(hflat, ("batch", None, "inner"))
    y = hflat + params["skip"].to(xc.dtype) * xc
    return (y * F.silu(z)) @ params["down_proj"]


def mlstm_apply(
    params,
    x: torch.Tensor,                                 # (B, T, E)
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]],
    mode: str = "prefill",                           # train | prefill | decode
) -> torch.Tensor:
    """Returns the mixer output (B, T, E). Prefill writes the state after
    the last prompt token and the conv tail into ``cache``; decode (T = 1)
    steps them, in place. A DTensor ``x`` runs on the mesh
    (:func:`_mlstm_sharded`)."""
    B, T, E = x.shape
    dI, H, Dh = _mlstm_dims(cfg)
    if mode == "decode" and (cache is None or T != 1):
        raise ValueError("decode takes one token and a cache")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    up = x @ params["up_proj"]
    if isinstance(up, DTensor):
        return _mlstm_sharded(params, up, cfg, cache, mode, x.dtype)
    xm, z = up.chunk(2, dim=-1)
    xc = _conv(params, xm, cache, mode)             # decode steps the tail
    q = (xc @ params["wq"]).view(B, T, H, Dh)
    k = (xc @ params["wk"]).view(B, T, H, Dh)
    v = (xm @ params["wv"]).view(B, T, H, Dh)
    gates = xc.float() @ params["w_if"] + params["b_if"]
    h, state = _mlstm_mix(q, k, v, gates, cache, mode, cfg.xlstm.chunk)
    if mode == "prefill" and cache is not None:
        for name, st in zip(("C", "n", "m"), state):
            cache[name].copy_(st)
        cache["conv"].copy_(_tail(xm, cfg.xlstm.conv_kernel))
    return _mlstm_out(params, h, xc, z, cfg, x.dtype)


def _mlstm_sharded(params, up: DTensor, cfg: ModelConfig, cache, mode: str,
                   dtype: torch.dtype) -> torch.Tensor:
    """The mLSTM of DTensor ``up`` (B, T, 2dI), the up projection, on a
    mesh, the reference's design: the causal conv on each rank's
    ``"inner"`` channels (``mamba.sharded_conv``); ``wq``, ``wk``, ``wv``
    and ``w_if`` row-parallel over ``"inner"``, their partial sums
    all-reduced, so that q, k, v and the gates are whole in the heads and
    split over ``"batch"`` alone; the log-space gates and the chunk loop
    in one ``local_map`` over the batch axes, on each rank's rows. Decode
    steps the cache's C, n and m on each rank's heads as well (``"heads"``,
    where its axes divide them: a slice of the replicated q, k, v and
    state, the new state gathered back), as the reference's partitioner
    splits the step."""
    mesh = up.device_mesh
    B, T, _ = up.shape
    dI, H, Dh = _mlstm_dims(cfg)
    (xc, z, xm, *tail), _pl = sharded_conv(params, up, cache, mode,
                                           cfg.xlstm.conv_kernel,
                                           keep_input=True)
    heads = "heads" if mode == "decode" else None

    def rows(a, w):
        return constrain(a @ w, ("batch", None, None))

    q, k, v = (constrain(rows(a, params[w]).view(B, T, H, Dh),
                         ("batch", None, heads, None))
               for a, w in ((xc, "wq"), (xc, "wk"), (xm, "wv")))
    gates = constrain((rows(xc.float(), params["w_if"]) + params["b_if"]
                       ).view(B, T, 2, H), ("batch", None, None, heads))
    names = ("C", "n", "m")
    state = {}
    if mode == "decode":
        state = {n: constrain(cache[n], ("batch", heads) + (None,) * (
            cache[n].dim() - 2)) for n in names}
    out_pl = list(q.placements)

    def cell(q, k, v, gates, *st):
        h, new = _mlstm_mix(q, k, v, gates, dict(zip(names, st)), mode,
                            cfg.xlstm.chunk)
        return h if new is None or mode == "train" else (h, *new)

    ins = (q, k, v, gates, *state.values())
    n_out = 4 if mode == "prefill" else 1
    out = local_map(cell, out_placements=(out_pl,) * n_out if n_out > 1
                    else out_pl,
                    in_placements=tuple(t.placements for t in ins),
                    device_mesh=mesh)(*ins)
    h = out[0] if n_out > 1 else out
    if mode == "decode":
        for name in names:
            cache[name].copy_(state[name].redistribute(
                mesh, cache[name].placements))
    if mode == "prefill" and cache is not None:
        for name, st in zip(names, out[1:]):
            cache[name].copy_(st.redistribute(mesh, cache[name].placements))
        cache["conv"].copy_(tail[0].redistribute(mesh,
                                                 cache["conv"].placements))
    return _mlstm_out(params, h, xc, z, cfg, dtype)


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


def _slstm_loop(wx: torch.Tensor, r_gates: torch.Tensor, state: State,
                H: int, Dh: int) -> Tuple[torch.Tensor, State]:
    """(hs (B, T, H, Dh), the state after the last step): the cell stepped
    over the T positions of ``wx`` (B, T, 4E) from ``state``, one step a
    position, as the JAX package's ``lax.scan``."""
    steps = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(state, wx[:, t], r_gates, H, Dh)
        steps.append(state[0])
    return torch.stack(steps, dim=1), state


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
    ``cache``; decode (T = 1) steps it once from the cache's state, in
    place. On a mesh the loop runs in one ``local_map`` over the batch
    axes (:func:`_slstm_sharded`)."""
    B, T, E = x.shape
    H = cfg.n_heads
    Dh = E // H
    act = activation(cfg.act)
    if mode == "decode" and (cache is None or T != 1):
        raise ValueError("decode takes one token and a cache")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    wx = (x @ params["w_gates"] + params["b_gates"].to(x.dtype)).float()
    r_gates = params["r_gates"].float()
    names = ("h", "c", "n", "m")
    if isinstance(wx, DTensor):
        hs, state = _slstm_sharded(wx, r_gates, cache, mode, H, Dh)
    else:
        if mode == "decode":
            state = tuple(cache[n] for n in names)
        else:
            zero = torch.zeros((B, H, Dh), dtype=torch.float32,
                               device=x.device)
            state = (zero, zero, torch.ones_like(zero), zero)
        hs, state = _slstm_loop(wx, r_gates, state, H, Dh)
    if mode != "train" and cache is not None:
        for name, st in zip(names, state):
            cache[name].copy_(st)

    y = hs.reshape(B, T, E).to(x.dtype)
    y = rms_norm(y, params["group_norm"], cfg.norm_eps)
    hmlp = act(y @ params["mlp_wg"]) * (y @ params["mlp_wi"])
    return y + hmlp @ params["mlp_wo"]


def _slstm_sharded(wx: DTensor, r_gates: DTensor, cache, mode: str,
                   H: int, Dh: int) -> Tuple[torch.Tensor, Optional[State]]:
    """The sLSTM loop of DTensor ``wx`` (B, T, 4E) on a mesh, the
    reference's ``shard_map`` over the batch axes: ``wx`` goes to
    ("batch", None, None), and the whole loop runs in one ``local_map`` on
    each rank's rows. ``r_gates`` enters replicated, its gradient
    ``Partial`` over the batch axes: each rank accumulates its cotangent
    over all T steps and one all-reduce sums them at the boundary (the
    reference's ``pvary``), never one a step. Decode steps the cache's
    state on each rank's heads as well (``"heads"``, where its axes divide
    them, as the cache's ``h`` is placed and as the reference's
    partitioner splits the step: the cell is per head). Returns (hs (B, T,
    H, Dh), the state after the last step on the cache's placements, or
    None in train)."""
    mesh = wx.device_mesh
    B, T, _ = wx.shape
    heads = "heads" if mode == "decode" else None
    wx = constrain(constrain(wx, ("batch", None, None)).view(B, T, H, 4 * Dh),
                   ("batch", None, heads, None))
    r_gates = constrain(r_gates, (heads, None, None))
    grad_r = [Partial() if p == Shard(0) else q
              for p, q in zip(wx.placements, r_gates.placements)]
    names = ("h", "c", "n", "m")
    state = (tuple(constrain(cache[n], ("batch", heads, None)) for n in names)
             if mode == "decode" else ())
    st_pl = [Shard(1) if p == Shard(2) else p for p in wx.placements]

    def loop(wx, r_gates, *st):
        Bl, Hl = wx.shape[0], r_gates.shape[0]
        if not st:
            zero = torch.zeros((Bl, Hl, Dh), dtype=torch.float32,
                               device=wx.device)
            st = (zero, zero, torch.ones_like(zero), zero)
        hs, st = _slstm_loop(wx.reshape(Bl, T, -1), r_gates, st, Hl, Dh)
        return hs if mode == "train" else (hs, *st)

    n_out = 1 if mode == "train" else 5
    ins = (wx, r_gates, *state)
    hs_pl = list(wx.placements)
    out = local_map(
        loop, out_placements=hs_pl if n_out == 1 else (hs_pl,) + (st_pl,) * 4,
        in_placements=tuple(t.placements for t in ins),
        in_grad_placements=(hs_pl, grad_r, *(st_pl,) * len(state)),
        device_mesh=mesh)(*ins)
    if n_out == 1:
        return out, None
    return out[0], tuple(st.redistribute(mesh, cache[n].placements)
                         for n, st in zip(names, out[1:]))


def slstm_alloc_cache(cfg: ModelConfig, batch: int, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """Zero decode cache of one sLSTM mixer (``slstm_cache_specs``): h, c,
    n, m, each (B, H, Dh) f32."""
    H = cfg.n_heads
    Dh = cfg.d_model // H
    return {name: torch.zeros((batch, H, Dh), dtype=torch.float32,
                              device=device) for name in ("h", "c", "n", "m")}
