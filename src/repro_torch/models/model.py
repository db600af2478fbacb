"""Model assembly: embedding (or frames) -> layers -> final norm -> lm head
(port of ``repro.models.model``).

Where the JAX package stacks each pattern position's parameters over a
leading ``layers`` axis and scans over groups, the port holds one module
per layer in an ``nn.ModuleList`` and loops. Layer ``l`` is pattern
position ``l % len(pattern)`` of group ``l // len(pattern)``. Under a
sharding context (:mod:`repro_torch.sharding.rules`) with DTensor
weights, the reference's sharding constraints place the activations
(``constrain``: the residual stream split over the batch and sequence
axes at each pattern group's entry and exit), each layer's weight
gradients take the weights' placements (``grad_constrained``), and the
embedding is a vocab-parallel ``local_map`` lookup; without one they are
the identity.

A trainable model (``Model(cfg, device, trainable=True)``) holds f32
master weights with gradients and casts them to ``cfg.dtype`` on every
forward, as the JAX ``forward`` does (``_cast``); its ``train`` forward
recomputes each layer in the backward when ``cfg.remat == "full"``, and
returns the MoE aux vector summed over layers, as prefill does, so the
load-balance and router-z losses reach the gradients. A ``mamba`` layer
trains through the selective scan's autograd function (the CUDA forward
and backward kernels on the card). ``remat="dots"`` saves the products
with no batch dimension (``x @ W``) and recomputes the rest, the flash
kernels included, as ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable`` does.

A ``frames`` model (the audio family) takes (B, T, E) frame embeddings in
place of tokens and has no embedding table; a vlm model takes encoder
embeddings (B, N, E) beside its tokens, which every cross-attention layer
attends. Both are cast to the compute dtype once a call.

Every decode cache is preallocated (:meth:`Model.alloc_cache`, each
layer's from its own ``LayerSpec``) and written in place, and
:meth:`Model.decode_step` takes its position as an int or as a 0-d tensor
on the device, so a decode step can be captured once and replayed
(:class:`repro_torch.train.step.CapturedDecode`).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import LayerSpec, ModelConfig
from ..core.regions import profiler_span
from ..sharding import rules as R
from ..sharding.collectives import psum, psum_scatter
from . import attention, mamba, moe, xlstm
from .blocks import alloc_cache, block_apply, block_specs, mlp_specs
from .common import (ParamSpec, SpecModule, cast_params, init_module_,
                     param_dtype, rms_norm)

Cache = List[Dict[str, Any]]
# the fixed-size aux vector of the JAX ``forward``, in its order
_AUX_KEYS = ("moe_aux_loss", "moe_load_balance", "moe_router_z",
             "moe_dropped_frac")


def _specs_by_path(specs, prefix: str) -> Dict[str, ParamSpec]:
    out = {}
    for name, spec in specs.items():
        path = f"{prefix}{name}"
        if isinstance(spec, ParamSpec):
            out[path] = spec
        else:
            out.update(_specs_by_path(spec, path + "."))
    return out


def model_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Every parameter's spec by its path in :class:`Model` (``embed``,
    ``layers.3.mixer.wq``, ...): the reference's ``model_specs`` with one
    entry a layer where the reference stacks each pattern position over a
    leading ``layers`` axis, so the logical axes are the reference's
    without that first one."""
    Vp, E = cfg.padded_vocab_size, cfg.d_model
    specs: Dict[str, ParamSpec] = {}
    if cfg.input_mode != "frames":
        specs["embed"] = ParamSpec((Vp, E), ("vocab", None))
    specs["final_norm"] = ParamSpec((E,), (None,), init="zeros")
    specs["lm_head"] = ParamSpec((E, cfg.n_codebooks * Vp), (None, "vocab"))
    for l in range(cfg.n_layers):
        specs.update(_specs_by_path(
            block_specs(cfg, cfg.pattern[l % len(cfg.pattern)]), f"layers.{l}."))
    return specs


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    return {name: spec.axes for name, spec in model_specs(cfg).items()}


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    return {name: spec.shape for name, spec in model_specs(cfg).items()}


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of ``remat="dots"``: keep the
    outputs of ``aten.mm`` (``x @ W`` lowers to it: a product with no batch
    dimension), recompute every other op, ``bmm`` and the flash
    attention's autograd function among them."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class Model(nn.Module):
    """Decoder-only LM over tokens or frames.

    Inference-only (the default): matrices are held in the compute dtype
    (``cfg.dtype``), 1-D norm scales in f32, ``requires_grad=False``.
    ``trainable=True``: every weight is f32 with ``requires_grad=True``,
    cast per forward.
    """

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.trainable = trainable
        # every layer kind that builds also trains (mamba through the
        # selective scan's backward kernel)
        self.can_train = True
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.specs: Dict[str, ParamSpec] = model_specs(cfg)
        for name, spec in self.specs.items():
            if "." not in name:
                self.register_parameter(name, nn.Parameter(torch.empty(
                    spec.shape, dtype=param_dtype(spec, self.compute_dtype,
                                                  trainable, name),
                    device=device), requires_grad=trainable))
        self.layers = nn.ModuleList(
            SpecModule(block_specs(cfg, cfg.pattern[l % len(cfg.pattern)]),
                       self.compute_dtype, device, trainable)
            for l in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def init_weights(self, seed: int) -> "Model":
        """Seeded random weights (per tensor, from ``seed`` and its path)."""
        init_module_(self, self.specs, seed)
        return self

    def alloc_cache(self, batch: int, seq_len: int) -> Cache:
        """Empty per-layer decode caches for ``seq_len`` positions: KV
        caches (pos -1) of ``seq_len`` slots for global attention layers
        and of ``min(seq_len, window)`` for windowed ones, zero recurrent
        state for mamba, mLSTM and sLSTM layers."""
        cfg = self.cfg
        return [alloc_cache(cfg, cfg.pattern[l % len(cfg.pattern)], batch,
                            seq_len, self.device)
                for l in range(cfg.n_layers)]

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the table cast to the compute dtype, scaled by
        sqrt(d_model) rounded to that dtype, as the JAX package does (a
        Python scalar: no device copy). The table is cast before the
        lookup, so a trainable model's embedding gradient sums duplicate
        tokens in the compute dtype, as JAX's does."""
        dt = self.compute_dtype
        scale = float(torch.tensor(math.sqrt(float(self.cfg.d_model)), dtype=dt))
        table = self.embed.to(dt)
        if isinstance(table, DTensor):
            return _vocab_parallel_embed(table, tokens) * scale
        return table[tokens] * scale

    def embed_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """The first hidden states: tokens (B, T) through the table, or
        frame embeddings (B, T, E) of a ``frames`` model cast to the
        compute dtype."""
        if self.cfg.input_mode == "frames":
            return x.to(self.compute_dtype)
        return self.embed_tokens(x)

    def _layers(self, x: torch.Tensor, pos, caches: Optional[Cache],
                mode: str, enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every layer, then the final norm. ``enc``, the encoder
        embeddings, is cast to the compute dtype here, once for every
        layer. Returns (x, aux (4,) f32): the MoE stats summed over layers,
        as the JAX ``_aux_vector``."""
        cfg = self.cfg
        if enc is not None:
            enc = enc.to(self.compute_dtype)
        aux = torch.zeros((len(_AUX_KEYS),), dtype=torch.float32,
                          device=x.device)
        # sequence-parallel residual stream under a mesh: each pattern
        # group enters and leaves it sharded over the model axis
        x = R.constrain(x, ("batch", "act_seq", None))
        plen = len(cfg.pattern)
        for l, layer in enumerate(self.layers):
            lspec = cfg.pattern[l % plen]
            if mode == "train":
                x, layer_aux = self._train_layer(layer, x, lspec, enc, l)
            else:
                x, layer_aux = block_apply(layer, x, cfg, lspec, pos,
                                           caches[l], mode=mode, enc=enc)
                layer_aux = _aux_vector(layer_aux)
            if layer_aux is not None:
                aux = aux + layer_aux
            if (l + 1) % plen == 0:
                x = R.constrain(x, ("batch", "act_seq", None))
        return rms_norm(x, self.final_norm, cfg.norm_eps), aux

    def _train_layer(self, layer: SpecModule, x: torch.Tensor, lspec,
                     enc: Optional[torch.Tensor] = None, index: int = 0
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One layer (``layers.{index}``) of the train forward on weights
        cast inside it, so a
        recomputed layer casts again and no cast copy outlives it. Returns
        (x, the layer's aux vector, or None without an MoE FFN); under
        remat the aux comes out of the checkpoint beside x, so its
        gradient flows through the recomputed layer. ``enc`` enters as a
        closure (it needs no gradient): the recompute reads the same
        tensor. Under a mesh each weight's gradient is constrained to the
        weight's own placement (``grad_constrained``)."""
        cfg = self.cfg
        prefix = f"layers.{index}."

        def constrained(name: str, p: torch.Tensor) -> torch.Tensor:
            return R.grad_constrained(p, self.specs[prefix + name].axes)

        def run(x):
            # a span of its own, so a device trace tells the remat's second
            # forward (inside train/backward) from the first
            with profiler_span("model/layer"):
                x, aux = block_apply(cast_params(layer, self.compute_dtype,
                                                 constrained),
                                     x, cfg, lspec, 0, None, mode="train",
                                     enc=enc)
            return x, _aux_vector(aux)

        run = R.keep_context(run)
        if cfg.remat == "none":
            return run(x)
        if cfg.remat == "full":
            return checkpoint(run, x, use_reentrant=False)
        if cfg.remat == "dots":
            return checkpoint(run, x, use_reentrant=False, context_fn=(
                functools.partial(create_selective_checkpoint_contexts,
                                  _save_dots)))
        raise ValueError(f"unknown remat policy {cfg.remat!r}")

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """(B, E) hidden -> (B, n_codebooks, Vp) f32 logits, pad masked."""
        logits = (h @ self.lm_head).float()
        B = logits.shape[0]
        logits = logits.view(B, self.cfg.n_codebooks, self.cfg.padded_vocab_size)
        return mask_pad_logits(logits, self.cfg)

    def forward(self, inputs: torch.Tensor, caches: Optional[Cache] = None,
                mode: str = "prefill", enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run ``inputs`` from position 0 (tokens (B, T), or frames (B, T,
        E) for a ``frames`` model; ``enc`` the encoder embeddings (B, N, E)
        of a vlm model) and return (hidden states (B, T, E), aux (4,) f32:
        [moe_aux_loss, load balance, router z, dropped fraction]) as the
        JAX ``forward`` does. ``prefill`` fills ``caches`` in place;
        ``train`` takes no caches and is differentiable (trainable models
        only)."""
        if mode == "train":
            if not self.trainable:
                raise ValueError("mode='train' needs Model(..., trainable=True)")
            caches = None
        elif mode != "prefill":
            raise ValueError(f"forward runs train or prefill, got mode={mode!r}")
        return self._layers(self.embed_inputs(inputs), 0, caches, mode, enc)

    def decode_step(self, inputs: torch.Tensor, pos, caches: Cache
                    ) -> torch.Tensor:
        """One decode step of ``inputs`` (tokens (B, 1), or frames (B, 1,
        E)) at position ``pos`` (an int, or a 0-d int tensor on the model's
        device, which nothing reads back to the host); updates ``caches``
        in place (a cross-attention layer reads the encoder's keys and
        values its prefill cached) and returns logits (B, n_codebooks,
        Vp)."""
        h, _aux = self._layers(self.embed_inputs(inputs), pos, caches,
                               "decode")
        return self.logits(h[:, 0])


def _vocab_parallel_embed(table: DTensor, tokens: torch.Tensor
                          ) -> torch.Tensor:
    """Rows of a DTensor ``table`` (Vp, E) for ``tokens`` (B, T), as a
    ``local_map`` over each rank's shards.

    With the table's vocab split over a model axis of more than one rank,
    this is the reference's ``shard_map`` masked *local* lookup +
    ``psum_scatter``: each model shard gathers the ids it owns, and the
    partial rows are reduce-scattered straight into the
    sequence-parallel layout (or summed, when the sequence does not
    split), so the table is never gathered; the backward is a
    shard-local scatter-add. Otherwise each rank looks up its own tokens
    in its whole table. Where the tokens are split over an axis that the
    table is replicated on, each rank's table gradient is a partial sum
    (``Partial``)."""
    mesh = table.device_mesh
    names = mesh.mesh_dim_names or ()
    md = names.index("model") if "model" in names else None
    split = (md is not None and mesh.size(md) > 1
             and table.placements[md] == Shard(0))
    ctx = R.current()
    if ctx is not None:
        tokens = R.constrain(tokens, ("batch", None))
    tokens = R.replicated_like(tokens, table)
    scatter_seq = False
    if split:
        model_size = mesh.size(md)
        v_shard = table.shape[0] // model_size
        scatter_seq = (ctx is not None and ctx[1].get("act_seq") == "model"
                       and tokens.shape[-1] % model_size == 0)
        group = mesh.get_group(md)
        lo = mesh.get_local_rank(md) * v_shard

    def local(tab, tok):
        if not split:
            return tab[tok]
        ids = (tok - lo).clamp(0, v_shard - 1)
        ok = (tok >= lo) & (tok < lo + v_shard)
        x = torch.where(ok[..., None], tab[ids],
                        torch.zeros((), dtype=tab.dtype, device=tab.device))
        return psum_scatter(x, group, 1) if scatter_seq else psum(x, group)

    out_pl, tab_grad = [], []
    for d, (pt, pk) in enumerate(zip(table.placements, tokens.placements)):
        if d == md and split:
            out_pl.append(Shard(1) if scatter_seq else Replicate())
            tab_grad.append(pt)
        elif pt == Replicate() or mesh.size(d) == 1:
            out_pl.append(pk)
            # each rank's rows are a partial sum of the table's gradient
            tab_grad.append(Partial() if pk != Replicate() else pt)
        else:
            raise ValueError(f"embedding over table {table.placements} and "
                             f"tokens {tokens.placements}")
    return local_map(local, out_placements=out_pl,
                     in_placements=(table.placements, tokens.placements),
                     in_grad_placements=(tab_grad, tokens.placements),
                     device_mesh=mesh)(table, tokens)


def _aux_vector(aux: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """A block's MoE stats as the (4,) f32 vector of ``_AUX_KEYS``, or
    None for a block without them (the JAX ``_aux_vector`` gives zeros)."""
    if not aux:
        return None
    return torch.stack([aux[k].float() for k in _AUX_KEYS])


def mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e30 the padded vocab tail so sampling/argmax never picks it."""
    Vp = cfg.padded_vocab_size
    if Vp == cfg.vocab_size:
        return logits
    valid = torch.arange(Vp, device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, torch.full_like(logits, -1e30))


# ---------------------------------------------------------------------------
# parameter counts (the JAX ``param_count``/``active_param_count``), over the
# reference's spec layout for every layer kind, ported or not
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> List[Tuple[int, ...]]:
    """Shapes of one pattern position's parameters (the reference's
    ``block_specs``): pre-norms, the mixer, cross-attention, the FFN."""
    def of(specs) -> List[Tuple[int, ...]]:
        return [s.shape for s in specs.values()]

    E = cfg.d_model
    shapes = [(E,)]
    if spec.mixer == "attn":
        shapes += of(attention.attn_specs(cfg))
    elif spec.mixer == "mamba":
        shapes += of(mamba.mamba_specs(cfg))
    elif spec.mixer == "mlstm":
        shapes += of(xlstm.mlstm_specs(cfg))
    elif spec.mixer == "slstm":
        shapes += of(xlstm.slstm_specs(cfg))
    if spec.cross_attn:                 # norm, projections, a scalar gate
        shapes += [(E,), *of(attention.cross_attn_specs(cfg))]
    if spec.ffn == "mlp":
        shapes += [(E,), *of(mlp_specs(cfg))]
    elif spec.ffn == "moe":
        shapes += [(E,), *of(moe.moe_specs(cfg))]
    return shapes


def param_count(cfg: ModelConfig) -> int:
    """Every parameter of ``cfg``'s model: the embedding (token input),
    each pattern position times ``n_groups``, the final norm, the lm head."""
    Vp, E = cfg.padded_vocab_size, cfg.d_model
    n = 0 if cfg.input_mode == "frames" else Vp * E
    for spec in cfg.pattern:
        n += cfg.n_groups * sum(math.prod(s) for s in _layer_shapes(cfg, spec))
    return n + E + E * cfg.n_codebooks * Vp


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only;
    padded dead experts never receive tokens)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe_layers = sum(1 for s in cfg.pattern if s.ffn == "moe") * cfg.n_groups
    per_expert = 3 * cfg.d_model * m.d_expert
    inactive = n_moe_layers * (cfg.padded_n_experts - m.top_k) * per_expert
    return total - inactive
