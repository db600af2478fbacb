"""Mamba-1 selective-state-space mixer, jamba's sequence layer (port of
``repro.models.mamba``).

Prefill and train run the whole sequence through
:func:`repro_torch.kernels.mamba_scan.ops.selective_scan` (the CUDA kernel
on the card, its plain version on the CPU). Prefill takes the cache's
state from the scan's final state. The JAX package runs a jnp scan in
chunks of 128 steps over time padded to a multiple of the chunk, and keeps
the state after the pad steps; the port pads nothing and keeps the state
after the last prompt token. Train writes no cache, so the pad steps do
not reach it: its gradient through the scan is the CUDA backward kernel
on the card (``SelectiveScan``), autograd through the plain version on the
CPU, where the JAX package differentiates its jnp scan with ``jax.grad``.
Decode is one recurrence step against the carried (h, conv tail) cache,
in plain torch, as the JAX package does it in jnp. On a mesh (DTensor
weights and caches) the per-channel part runs on each rank's ``"inner"``
channels (:func:`_sharded`), the scan kernel on local shards.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..kernels.mamba_scan.ops import selective_scan
from ..sharding.rules import constrain
from .common import ParamSpec


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    return d_inner, m.d_state, m.d_conv, m.dt_rank_for(cfg.d_model)


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    E = cfg.d_model
    dI, N, dC, R = _dims(cfg)
    return {
        "in_proj": ParamSpec((E, 2 * dI), ("embed", "inner")),
        "conv_w": ParamSpec((dC, dI), (None, "inner"), init="normal", scale=0.1),
        "conv_b": ParamSpec((dI,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((dI, R + 2 * N), ("inner", None)),
        "dt_w": ParamSpec((R, dI), (None, "inner")),
        "dt_b": ParamSpec((dI,), ("inner",), init="const", scale=-4.6),  # softplus^-1(0.01)
        "A_log": ParamSpec((dI, N), ("inner", "state"), init="mamba_a",
                           dtype=torch.float32),
        "D": ParamSpec((dI,), ("inner",), init="ones", dtype=torch.float32),
        "out_proj": ParamSpec((dI, E), ("inner", "embed"), init="scaled", scale=1.0),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time in x's dtype. x: (B, T, dI); w:
    (dC, dI); ``tail`` the (B, dC-1, dI) inputs before x (zeros if None).
    The taps are summed in order, then the bias, as the JAX package's
    ``sum``; the bias (an f32 1-D parameter here) is cast to x's dtype."""
    dC, T = w.shape[0], x.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, dC - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, dC):
        out = out + xp[:, i:i + T] * w[i]
    return out + b.to(x.dtype)


def _project(params, x_dbl: torch.Tensor, R: int, N: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dt, Bc, Cc), all f32, from the f32 (…, R+2N) projection ``x_dbl``
    of the conv output; Bc and Cc are views into it."""
    dt_low, Bc, Cc = x_dbl.split([R, N, N], dim=-1)
    dt = F.softplus(dt_low @ params["dt_w"].float() + params["dt_b"].float())
    return dt, Bc, Cc


def _conv(params, xin: torch.Tensor, cache, mode: str) -> torch.Tensor:
    """SiLU of the causal conv of ``xin`` (B, T, dI); decode reads the
    cache's conv tail and steps it in place."""
    if mode != "decode":
        return F.silu(_causal_conv(xin, params["conv_w"], params["conv_b"]))
    conv_tail = cache["conv"]                                    # (B, dC-1, dI)
    xc = F.silu(_causal_conv(xin, params["conv_w"], params["conv_b"],
                             tail=conv_tail))
    cache["conv"].copy_(torch.cat([conv_tail[:, 1:], xin], dim=1))
    return xc


def _tail(xin: torch.Tensor, dC: int) -> torch.Tensor:
    """The last dC-1 raw conv inputs (zero-padded if T < dC-1)."""
    return F.pad(xin, (0, 0, dC - 1, 0))[:, -(dC - 1):]


def _ssm(params, xc: torch.Tensor, z: torch.Tensor, x_dbl: torch.Tensor,
         cache, mode: str, R: int, N: int, dtype: torch.dtype
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the gated scan output (B, T, dI) in ``dtype``, the final state (B,
    dI, N) f32, or None in decode): the selective scan of train and
    prefill, or decode's one recurrence step against the cache's state,
    stepped in place. Every op is per channel: on a mesh each rank runs
    it on its own channels."""
    A = -torch.exp(params["A_log"].float())                      # (dI, N)
    dt, Bc, Cc = _project(params, x_dbl, R, N)
    if mode == "decode":
        dA = torch.exp(dt[:, 0, :, None] * A)                    # (B, dI, N)
        dBx = (dt[:, 0] * xc[:, 0])[..., None] * Bc[:, 0, None, :]
        h = dA * cache["h"] + dBx
        y = (h * Cc[:, 0, None, :]).sum(-1) + params["D"] * xc[:, 0]
        cache["h"].copy_(h)
        return (y[:, None] * F.silu(z)).to(dtype), None
    y, h = selective_scan(xc, dt, A, Bc, Cc, params["D"], return_state=True)
    return (y * F.silu(z)).to(dtype), h


def mamba_apply(
    params,
    x: torch.Tensor,                         # (B, T, E)
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]],
    mode: str = "prefill",                   # train | prefill | decode
) -> torch.Tensor:
    """Returns the mixer output (B, T, E). Prefill writes the final state
    and the conv tail into ``cache``; decode (T = 1) steps them, in
    place; train is prefill's computation without a cache. A DTensor
    ``x`` runs the per-channel part on each rank's channels
    (:func:`_sharded`)."""
    B, T, E = x.shape
    dI, N, dC, R = _dims(cfg)
    if mode == "decode" and (cache is None or T != 1):
        raise ValueError("decode takes one token and a cache")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(
            f"mamba runs train, prefill or decode, got mode={mode!r}")
    xz = x @ params["in_proj"]
    if isinstance(xz, DTensor):
        return _sharded(params, xz, cfg, cache, mode, x.dtype)
    xin, z = xz.chunk(2, dim=-1)
    xc = _conv(params, xin, cache, mode)
    y, h = _ssm(params, xc, z, (xc @ params["x_proj"]).float(), cache, mode,
                R, N, x.dtype)
    if mode == "prefill" and cache is not None:
        cache["h"].copy_(h)
        cache["conv"].copy_(_tail(xin, dC))
    return y @ params["out_proj"]


# ---------------------------------------------------------------------------
# the mixer on a mesh: each rank's channels
# ---------------------------------------------------------------------------

def _split_fused(t: torch.Tensor, mesh, d: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xin, z), each (B, T, dI/M), of this rank's block ``t`` (B, T,
    2dI/M) of the fused in_proj output split over mesh dimension ``d`` of
    size M: rank r holds fused columns [2r b, 2r b + 2b) (b = dI/M), and
    takes channels [r b, r b + b) of xin (fused block r) and of z (block M
    + r). One all-to-all over ``d`` sends each of the rank's two blocks
    to the rank that takes it."""
    import torch.distributed._functional_collectives as funcol

    M = mesh.size(d)
    if M == 1:
        return t.chunk(2, dim=-1)
    r = mesh.get_local_rank(d)
    b = t.shape[-1] // 2
    dest = [(2 * r + j) % M for j in (0, 1)]
    order = sorted((0, 1), key=lambda j: dest[j])
    blocks = torch.stack([t[..., j * b:(j + 1) * b] for j in order])
    src = (r // 2, (M + r) // 2)          # the ranks that hold blocks r, M+r
    out = funcol.all_to_all_single_autograd(
        blocks, [src.count(q) for q in range(M)],
        [dest.count(q) for q in range(M)], (mesh, d))
    return out[0], out[1]


def sharded_conv(params, xz: DTensor, cache, mode: str, dC: int,
                 keep_input: bool = False) -> Tuple[list, Callable]:
    """The conv block of a fused (B, T, 2dI) projection ``xz`` (conv input,
    then gate) on a mesh, after the reference: ``xz`` is placed on
    ("batch", None, "inner") with the sequence whole, and each rank splits
    its block into its own channels of both halves (:func:`_split_fused`)
    and runs the causal conv and its SiLU on them (``local_map``); decode
    steps the cache's conv tail shard in place. Returns ([xc, z, the conv
    input if ``keep_input``, the conv tail if prefill], each on ("batch",
    None, "inner"); ``pl``), where ``pl(inner=, batch=, other=)`` names a
    placement a mesh dimension by the kind of axis it is. The gradients of
    the conv's parameters come back ``Partial`` over the batch axes."""
    mesh = xz.device_mesh
    xz = constrain(xz, ("batch", None, "inner"))
    inner = [d for d, p in enumerate(params["conv_b"].placements)
             if p == Shard(0)]
    if [d for d, p in enumerate(xz.placements) if p == Shard(2)] != inner:
        raise ValueError(f"the channels split as {xz.placements} and "
                         f"{params['conv_b'].placements}")
    if len(inner) > 1:
        raise ValueError(f"the channels split over {len(inner)} mesh "
                         "axes; one is supported")
    batch = [d for d, p in enumerate(xz.placements) if p == Shard(0)]

    def pl(**by_dim):
        """A placement a mesh dimension: ``inner``, ``batch`` and ``other``
        name those of the channel axes, the batch axes and the rest."""
        return [by_dim["inner"] if d in inner else
                by_dim["batch"] if d in batch else
                by_dim.get("other", Replicate()) for d in range(mesh.ndim)]

    act = pl(inner=Shard(2), batch=Shard(0))              # (B, T, dI)
    conv_in = (xz, params["conv_w"], params["conv_b"])
    conv_cache = (cache["conv"],) if mode == "decode" else ()

    def conv_local(xz, conv_w, conv_b, *tail):
        xin, z = (_split_fused(xz, mesh, inner[0]) if inner
                  else xz.chunk(2, dim=-1))
        ps = {"conv_w": conv_w, "conv_b": conv_b}
        xc = _conv(ps, xin, {"conv": tail[0]} if tail else None, mode)
        # z (and xin) are views of a tensor that the block does not
        # return: as views, local_map's outputs would lose their gradient
        out = [xc, z.clone()]
        if keep_input:
            out.append(xin.clone())
        if mode == "prefill":
            out.append(_tail(xin, dC))
        return tuple(out)

    n_out = 2 + keep_input + (mode == "prefill")
    pls = [t.placements for t in conv_in + conv_cache]
    out = local_map(
        conv_local, out_placements=(act,) * n_out, in_placements=pls,
        in_grad_placements=(act, *(_param_grad(pl, inner, t)
                                   for t in conv_in[1:]), *pls[3:]),
        device_mesh=mesh)(*conv_in, *conv_cache)
    return list(out), pl


def _param_grad(pl: Callable, inner, p: DTensor):
    """A per-channel parameter's gradient: its own placement on the
    channel axes, ``Partial`` over the batch axes."""
    return pl(inner=p.placements[inner[0]] if inner else Replicate(),
              batch=Partial())


def _sharded(params, xz: DTensor, cfg: ModelConfig, cache, mode: str,
             dtype: torch.dtype) -> torch.Tensor:
    """The mixer of DTensor ``xz`` (B, T, 2dI), the in_proj output, on a
    mesh, after the reference: the conv block on each rank's channels
    (:func:`sharded_conv`), then the scan (its kernel on local, contiguous
    (B_l, T, dI_l) tensors) and the gate on them too (``local_map``).
    x_proj contracts over the channels, so its output (dt's low rank, Bc
    and Cc) is a partial sum over the channel axes, reduced before the
    scan; the gradients of the per-channel parameters, and of Bc and Cc,
    come back ``Partial`` over the axes they were replicated on. Decode
    steps the caches' shards in place; prefill writes them, the state
    after the last prompt token."""
    mesh = xz.device_mesh
    dI, N, dC, R = _dims(cfg)
    (xc, z, *tail), pl = sharded_conv(params, xz, cache, mode, dC)
    inner = [d for d, p in enumerate(xc.placements) if p == Shard(2)]
    act = pl(inner=Shard(2), batch=Shard(0))              # (B, T, dI)
    state = pl(inner=Shard(1), batch=Shard(0))            # (B, dI, N)
    x_dbl = (xc @ params["x_proj"]).redistribute(
        mesh, pl(inner=Replicate(), batch=Shard(0))).float()

    names = ("dt_w", "dt_b", "A_log", "D")
    ssm_in = (xc, z, x_dbl, *(params[n] for n in names))
    ssm_cache = (cache["h"],) if mode == "decode" else ()

    def ssm_local(xc, z, x_dbl, *rest):
        ps = dict(zip(names, rest))
        y, h = _ssm(ps, xc, z, x_dbl, {"h": rest[4]} if ssm_cache else None,
                    mode, R, N, dtype)
        return y if h is None else (y, h)

    pls = [t.placements for t in ssm_in + ssm_cache]
    out = local_map(
        ssm_local,
        out_placements=act if mode == "decode" else (act, state),
        in_placements=pls,
        in_grad_placements=(act, act, pl(inner=Partial(), batch=Shard(0)),
                            *(_param_grad(pl, inner, params[n])
                              for n in names),
                            *pls[7:]),
        device_mesh=mesh)(*ssm_in, *ssm_cache)
    y = out if mode == "decode" else out[0]
    if mode == "prefill" and cache is not None:
        cache["h"].copy_(out[1].redistribute(mesh, cache["h"].placements))
        cache["conv"].copy_(tail[0].redistribute(mesh,
                                                 cache["conv"].placements))
    return y @ params["out_proj"]


def alloc_cache(cfg: ModelConfig, batch: int, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """Zero decode cache of one mamba mixer (``mamba_cache_specs``): the
    state (B, dI, N) f32 and the conv tail (B, dC-1, dI) in cfg.dtype."""
    dI, N, dC, _ = _dims(cfg)
    return {
        "h": torch.zeros((batch, dI, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, dC - 1, dI), dtype=getattr(torch, cfg.dtype),
                            device=device),
    }
