"""Zero-allocation stand-ins for every step input of every cell (port of
``repro.launch.specs``).

The reference's ``jax.ShapeDtypeStruct`` is a tensor on the ``meta``
device here: it has a shape and a dtype and holds no memory. The dry run
(:mod:`repro_torch.launch.dryrun`) turns each into a fake tensor on its
device and places it on the mesh. The shapes and dtypes are the
reference's, leaf by leaf: the parameters and the caches stacked over
``n_groups`` per pattern position (``models.model.param_shapes`` and
``init_cache_shapes`` give the port's per-layer ones), tokens and labels
int32, the AdamW step an int32 scalar (the port keeps its step count on
the host; the spec stands for the reference's device scalar).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import model as M

I32 = torch.int32
META = torch.device("meta")


def spec(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (no memory)."""
    return torch.empty(shape, dtype=dtype, device=META)


def stacked_param_shapes(cfg: ModelConfig, dtype: torch.dtype
                         ) -> Dict[str, Any]:
    """The reference's parameter tree (``embed``, ``pos{i}`` stacked over
    the groups, ``final_norm``, ``lm_head``) as ``meta`` tensors in
    ``dtype`` (the reference's ``param_shapes(cfg, dtype)``: every leaf
    in it, f32 ParamSpecs included)."""
    plen = len(cfg.pattern)
    out: Dict[str, Any] = {}
    for name, ps in M.model_specs(cfg).items():
        shape, dt = ps.shape, ps.dtype or dtype
        if not name.startswith("layers."):
            out[name] = spec(shape, dt)
            continue
        _, layer, rest = name.split(".", 2)
        if int(layer) >= plen:
            continue
        node = out.setdefault(f"pos{layer}", {})
        *path, leaf = rest.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = spec((cfg.n_groups,) + tuple(shape), dt)
    # the reference's key order: embed, pos*, final_norm, lm_head
    order = [k for k in ("embed",) if k in out]
    order += [f"pos{i}" for i in range(plen)] + ["final_norm", "lm_head"]
    return {k: out[k] for k in order}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B = shape.global_batch
    T = 1 if shape.is_decode else shape.seq_len
    dt = getattr(torch, cfg.dtype)
    out: Dict[str, Any] = {}
    if cfg.input_mode == "frames":
        out["frames"] = spec((B, T, cfg.d_model), dt)
        if shape.kind == "train":
            out["labels"] = spec((B, T, cfg.n_codebooks), I32)
    else:
        out["tokens"] = spec((B, T), I32)
        if shape.kind == "train":
            out["labels"] = spec((B, T), I32)
    if cfg.input_mode == "tokens+image" and not shape.is_decode:
        out["encoder_embeddings"] = spec((B, cfg.encoder_len, cfg.d_model), dt)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All step inputs for one (arch x shape) cell.

    train:   {params, opt_state, batch}
    prefill: {params, batch}
    decode:  {params, caches, batch, pos}
    """
    if shape.kind == "train":
        params = stacked_param_shapes(cfg, torch.float32)
        opt = {"m": stacked_param_shapes(cfg, torch.float32),
               "v": stacked_param_shapes(cfg, torch.float32),
               "step": spec((), I32)}
        return {"params": params, "opt_state": opt,
                "batch": batch_specs(cfg, shape)}
    params = stacked_param_shapes(cfg, getattr(torch, cfg.dtype))
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_specs(cfg, shape)}
    caches = M.init_cache_shapes(cfg, shape.global_batch, shape.seq_len)
    return {
        "params": params,
        "caches": caches,
        "batch": batch_specs(cfg, shape),
        "pos": spec((), I32),
    }
