"""Model assembly: embedding -> layers -> final norm -> lm head
(port of ``repro.models.model``).

Where the JAX package stacks each pattern position's parameters over a
leading ``layers`` axis and scans over groups, the port holds one module
per layer in an ``nn.ModuleList`` and loops. Layer ``l`` is pattern
position ``l % len(pattern)`` of group ``l // len(pattern)``. Sharding
constraints are dropped: without a mesh they are the identity.

A trainable model (``Model(cfg, device, trainable=True)``) holds f32
master weights with gradients and casts them to ``cfg.dtype`` on every
forward, as the JAX ``forward`` does (``_cast``); its ``train`` forward
recomputes each layer in the backward when ``cfg.remat == "full"``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import alloc_cache
from .blocks import block_apply, block_specs
from .common import (ParamSpec, SpecModule, cast_params, init_module_,
                     param_dtype, rms_norm)

Cache = List[Dict[str, torch.Tensor]]


def _specs_by_path(specs, prefix: str) -> Dict[str, ParamSpec]:
    out = {}
    for name, spec in specs.items():
        path = f"{prefix}{name}"
        if isinstance(spec, ParamSpec):
            out[path] = spec
        else:
            out.update(_specs_by_path(spec, path + "."))
    return out


class Model(nn.Module):
    """Decoder-only LM over tokens.

    Inference-only (the default): matrices are held in the compute dtype
    (``cfg.dtype``), 1-D norm scales in f32, ``requires_grad=False``.
    ``trainable=True``: every weight is f32 with ``requires_grad=True``,
    cast per forward.
    """

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                f"{cfg.name}: input_mode={cfg.input_mode!r} is not ported yet "
                "(ROADMAP Queue 1, modules still missing)")
        self.cfg = cfg
        self.trainable = trainable
        self.compute_dtype = getattr(torch, cfg.dtype)
        Vp, E = cfg.padded_vocab_size, cfg.d_model
        self.specs: Dict[str, ParamSpec] = {
            "embed": ParamSpec((Vp, E), ("vocab", None)),
            "final_norm": ParamSpec((E,), (None,), init="zeros"),
            "lm_head": ParamSpec((E, cfg.n_codebooks * Vp), (None, "vocab")),
        }
        for name in ("embed", "final_norm", "lm_head"):
            spec = self.specs[name]
            self.register_parameter(name, nn.Parameter(torch.empty(
                spec.shape, dtype=param_dtype(spec, self.compute_dtype,
                                              trainable),
                device=device), requires_grad=trainable))
        self.layers = nn.ModuleList()
        for l in range(cfg.n_layers):
            lspec = cfg.pattern[l % len(cfg.pattern)]
            bspecs = block_specs(cfg, lspec)
            self.layers.append(SpecModule(bspecs, self.compute_dtype, device,
                                          trainable))
            self.specs.update(_specs_by_path(bspecs, f"layers.{l}."))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_weights(self, seed: int) -> "Model":
        """Seeded random weights (per tensor, from ``seed`` and its path)."""
        init_module_(self, self.specs, seed)
        return self

    def alloc_cache(self, batch: int, seq_len: int) -> Cache:
        """Empty per-layer KV caches of ``seq_len`` slots (pos -1)."""
        return [alloc_cache(self.cfg, batch, seq_len, self.device)
                for _ in range(self.cfg.n_layers)]

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the table cast to the compute dtype, scaled by
        sqrt(d_model) rounded to that dtype, as the JAX package does (a
        Python scalar: no device copy). The table is cast before the
        lookup, so a trainable model's embedding gradient sums duplicate
        tokens in the compute dtype, as JAX's does."""
        dt = self.compute_dtype
        scale = float(torch.tensor(math.sqrt(float(self.cfg.d_model)), dtype=dt))
        return self.embed.to(dt)[tokens] * scale

    def _layers(self, x: torch.Tensor, pos: int, caches: Optional[Cache],
                mode: str) -> torch.Tensor:
        cfg = self.cfg
        for l, layer in enumerate(self.layers):
            lspec = cfg.pattern[l % len(cfg.pattern)]
            if mode == "train":
                x = self._train_layer(layer, x, lspec)
            else:
                x = block_apply(layer, x, cfg, lspec, pos, caches[l], mode=mode)
        return rms_norm(x, self.final_norm, cfg.norm_eps)

    def _train_layer(self, layer: SpecModule, x: torch.Tensor, lspec
                     ) -> torch.Tensor:
        """One layer of the train forward on weights cast inside it, so a
        recomputed layer casts again and no cast copy outlives it."""
        cfg = self.cfg

        def run(x):
            return block_apply(cast_params(layer, self.compute_dtype), x, cfg,
                               lspec, 0, None, mode="train")

        if cfg.remat == "none":
            return run(x)
        if cfg.remat == "full":
            return checkpoint(run, x, use_reentrant=False)
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet: ROADMAP Queue 1, "
            "modules still missing (\"dots\" remat policy)")

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """(B, E) hidden -> (B, n_codebooks, Vp) f32 logits, pad masked."""
        logits = (h @ self.lm_head).float()
        B = logits.shape[0]
        logits = logits.view(B, self.cfg.n_codebooks, self.cfg.padded_vocab_size)
        return mask_pad_logits(logits, self.cfg)

    def forward(self, tokens: torch.Tensor, caches: Optional[Cache] = None,
                mode: str = "prefill") -> torch.Tensor:
        """Run ``tokens`` (B, T) from position 0 and return the hidden
        states (B, T, E). ``prefill`` fills ``caches`` in place; ``train``
        takes no caches and is differentiable (trainable models only)."""
        if mode == "train":
            if not self.trainable:
                raise ValueError("mode='train' needs Model(..., trainable=True)")
            return self._layers(self.embed_tokens(tokens), 0, None, "train")
        if mode != "prefill":
            raise ValueError(f"forward runs train or prefill, got mode={mode!r}")
        return self._layers(self.embed_tokens(tokens), 0, caches, "prefill")

    def decode_step(self, tokens: torch.Tensor, pos: int, caches: Cache
                    ) -> torch.Tensor:
        """One decode step of ``tokens`` (B, 1) at position ``pos``; updates
        ``caches`` in place and returns logits (B, n_codebooks, Vp)."""
        h = self._layers(self.embed_tokens(tokens), pos, caches, "decode")
        return self.logits(h[:, 0])


def mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e30 the padded vocab tail so sampling/argmax never picks it."""
    Vp = cfg.padded_vocab_size
    if Vp == cfg.vocab_size:
        return logits
    valid = torch.arange(Vp, device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, torch.full_like(logits, -1e30))
