"""Logical-axis -> mesh-axis rules and placements (port of
``repro.sharding.rules``).

Parallelism map (production mesh (pod, data, model) / (data, model)):

  batch        -> ("pod", "data")   data parallelism (+pod DP across pods)
  embed        -> "data"            FSDP: params + optimizer state sharded
  heads/kv_heads/mlp/inner/experts/vocab -> "model"   tensor/expert parallel
  cache seq    -> "data" for long_500k (batch=1 -> sequence parallelism)
  everything else replicated

A ``torch.distributed`` ``DeviceMesh`` stands in for the JAX ``Mesh``, a
tuple of ``Shard``/``Replicate`` placements (one per mesh dimension) for a
``PartitionSpec``, ``distribute_tensor`` for ``device_put`` onto a
``NamedSharding`` and ``DTensor.redistribute`` for
``with_sharding_constraint``. A tensor dimension that maps to several mesh
axes, ``("pod", "data")``, is ``Shard(d)`` on each of them, major to minor
as the mesh orders them, which is the order JAX splits it in.

A contextvar carries (mesh, rules) so model code can place activation
constraints via :func:`constrain` without threading the mesh through
every call (the identity outside a sharding context, and on a plain
tensor). A plain tensor that meets a DTensor (a position table, a mask)
becomes a replicated DTensor first (:func:`replicated_like`).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..configs.base import ShapeConfig

Placements = Tuple[Any, ...]

_CTX: contextvars.ContextVar[Optional[Tuple[Any, Dict[str, Any]]]] = (
    contextvars.ContextVar("sharding_ctx", default=None)
)


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh axis name: size}, in the mesh's order: of a ``DeviceMesh``,
    or of a stand-in whose ``.shape`` is already such a mapping (a test
    stub with no processes behind it)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def make_rules(mesh, shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    sizes = axis_sizes(mesh)
    has_pod = "pod" in sizes
    batch = ("pod", "data") if has_pod else ("data",)
    # KV/state caches shard their *sequence* dim over "model" because
    # kv_heads (4-36 across the archs) rarely divide the model axis.
    seq_kv = ("model",)
    act_seq = "model"              # Megatron-style sequence parallelism
    if shape is not None and shape.is_decode:
        act_seq = None             # decode steps have T=1
        if shape.global_batch < sizes["data"]:
            # long-context decode (batch=1): batch can't cover the data
            # axis; fold it into the cache sequence sharding instead
            batch = None
            seq_kv = ("pod", "data", "model") if has_pod else ("data", "model")
    return {
        "batch": batch,
        "seq_kv": seq_kv,
        "act_seq": act_seq,
        "embed": "data",
        "heads": "model",
        "kv_heads": None,          # see seq_kv note
        "mlp": "model",
        "inner": "model",
        "experts": "model",
        "expert_mlp": None,
        "vocab": "model",
        "state": None,
        "layers": None,
    }


@contextlib.contextmanager
def sharding_context(mesh, rules: Dict[str, Any]):
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> Optional[Tuple[Any, Dict[str, Any]]]:
    """(mesh, rules) of the innermost sharding context, or None."""
    return _CTX.get()


def keep_context(fn: Callable) -> Callable:
    """``fn`` run under the sharding context current now, wherever it is
    called: a remat's recompute runs inside the backward, on the autograd
    engine's thread on a card, where the contextvar is unset, and must
    place its activations as the forward did."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with sharding_context(*ctx):
            return fn(*args, **kwargs)

    return run


def _flatten_entry(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _fit_entry(dim: int, entry, sizes: Optional[Mapping[str, int]]):
    """Drop mesh axes (from the right) until the dim divides evenly —
    a placement needs exact divisibility. ``sizes`` maps each mesh axis
    to its size (:func:`axis_sizes`); None keeps the entry."""
    if sizes is None:
        return entry
    names = _flatten_entry(entry)
    while names:
        prod = 1
        for n in names:
            prod *= sizes[n]
        if dim % prod == 0:
            return names if len(names) > 1 else names[0]
        names = names[:-1]
    return None


def pspec(
    axes: Tuple[Optional[str], ...],
    rules: Dict[str, Any],
    shape: Optional[Tuple[int, ...]] = None,
    mesh=None,
) -> Placements:
    """One placement per dimension of ``mesh``: ``Shard(i)`` on each mesh
    axis that the logical axis of tensor dimension ``i`` maps to, else
    ``Replicate()``. With ``shape``, mesh axes that do not divide their
    dimension are dropped (:func:`_fit_entry`)."""
    if mesh is None:
        raise ValueError("a placement needs the mesh's axes: pass mesh=")
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for i, a in enumerate(axes):
        entry = None if a is None else rules.get(a)
        if shape is not None:
            entry = _fit_entry(shape[i], entry, sizes)
        picked = _flatten_entry(entry)
        if [names.index(n) for n in picked] != sorted(
                names.index(n) for n in picked):
            raise ValueError(f"mesh axes {picked} of {a!r} are not in the "
                             f"mesh's order {tuple(names)}")
        for n in picked:
            if out[names.index(n)] != Replicate():
                raise ValueError(f"mesh axis {n!r} shards two dimensions "
                                 f"of {axes}")
            out[names.index(n)] = Shard(i)
    return tuple(out)


def constrain(x: torch.Tensor, axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    """``x`` redistributed to the placements of ``axes`` under the current
    context; the identity outside one, or on a plain tensor."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    return x.redistribute(mesh, pspec(axes, rules, shape=x.shape, mesh=mesh))


class _GradConstrained(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


def grad_constrained(x: torch.Tensor, axes: Tuple[Optional[str], ...]):
    """Identity whose *cotangent* is redistributed to the placements of
    ``axes``.

    Applied to layer parameters at their use in the forward so each
    layer's parameter gradient is reduce-scattered to the parameter's
    placement inside the backward, instead of arriving as a partial sum
    over the mesh. The identity outside a sharding context."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    return _GradConstrained.apply(
        x, mesh, pspec(axes, rules, shape=x.shape, mesh=mesh))


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``distribute_tensor`` whose local block holds a storage of its own:
    a block that is a view of ``t`` (a split of its leading dimension)
    would keep all of ``t`` alive on every rank."""
    d = distribute_tensor(t, mesh, placements)
    local = d._local_tensor
    if local.untyped_storage().nbytes() == local.nbytes:
        return d
    return DTensor.from_local(local.clone(), mesh, placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A plain tensor ``t`` (a position table, a mask) that meets DTensor
    ``ref`` in an operation, as a DTensor replicated on ``ref``'s mesh: a
    DTensor operation takes no plain tensor of more than one element, in
    the forward nor in its backward (which runs on the autograd engine's
    thread). ``t`` as it is when ``ref`` is a plain tensor."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard_block(x, dim: int) -> Tuple[int, int, Tuple[int, ...]]:
    """(first global index, length, the mesh dims that split it) of this
    rank's block of dimension ``dim`` of DTensor ``x``, split evenly (the
    rules place only dimensions that divide) major to minor in mesh
    order. Read from the mesh's coordinate: no tensor is touched."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    lo, n, dims = 0, x.shape[dim], []
    for d, p in enumerate(x.placements):
        if p == Shard(dim):
            n //= mesh.size(d)
            lo += coord[d] * n
            dims.append(d)
    return lo, n, tuple(dims)


def unshard(x):
    """A DTensor's global value as a plain tensor (``full_tensor``, a
    collective every rank must call); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts with one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_shardings(axes_tree, mesh, rules: Dict[str, Any], shapes_tree=None):
    """Map nested dicts of logical-axis tuples to placements on ``mesh``.
    When ``shapes_tree`` is given (leaves with a ``.shape``, or shape
    tuples), non-divisible mesh axes are dropped per dim."""
    if shapes_tree is None:
        return _map(lambda axes: pspec(axes, rules, mesh=mesh), axes_tree)
    return _map(lambda axes, s: pspec(axes, rules, shape=tuple(
        getattr(s, "shape", s)), mesh=mesh), axes_tree, shapes_tree)


# --- cache sharding (leaf-name based; see models.blocks.alloc_cache) --------

_CACHE_AXES = {
    # attention kv cache (stacked): (layers, batch, seq, kv_heads, head_dim)
    "k": ("layers", "batch", "seq_kv", "kv_heads", None),
    "v": ("layers", "batch", "seq_kv", "kv_heads", None),
    "pos": ("layers", "seq_kv"),
    # mamba: h (layers, batch, inner, state); conv (layers, batch, k, inner)
    "h": ("layers", "batch", "inner", "state"),
    "conv": ("layers", "batch", None, "inner"),
    # mlstm state
    "C": ("layers", "batch", None, None, None),
    "n": ("layers", "batch", None, None),
    "m": ("layers", "batch", None),
    # slstm state (same leaf names h/c/n/m at rank 4)
    "c": ("layers", "batch", None, None),
}


def _leaf_axes(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    axes = _CACHE_AXES.get(name)
    if axes is None or len(axes) != ndim:
        # fall back by rank: slstm h/n/m are rank-4/3 f32 states
        if name in ("h", "n", "m", "c"):
            axes = ("layers", "batch") + (None,) * (ndim - 2)
        else:
            axes = (None,) * ndim
    return tuple(axes)


def cache_axes(cache_shapes) -> Any:
    """Logical axes of every leaf of a cache tree (nested dicts of leaves
    with a ``.shape``), judged by the leaf's name and rank, as the
    reference's are for its stacked caches (leading ``layers`` dim)."""
    def rec(tree):
        return {k: rec(v) if isinstance(v, dict)
                else _leaf_axes(str(k), len(v.shape))
                for k, v in tree.items()}
    return rec(cache_shapes)


def cache_shardings(cache_shapes, mesh, rules: Dict[str, Any]):
    return tree_shardings(cache_axes(cache_shapes), mesh, rules, cache_shapes)


def layer_cache_shardings(stacked, n_layers: int):
    """The placements of the port's per-layer caches (a list, one dict a
    layer: the mixer's leaves and a cross-attention layer's ``cross_kv``)
    from :func:`cache_shardings` of the reference's stacked tree
    (``pos{i}`` -> ``mixer``, ``cross_kv``; a leading ``layers``
    dimension, never split): layer ``l`` takes position ``l % len``'s,
    each ``Shard(d)`` one dimension lower."""
    def drop(pl):
        return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                     for p in pl)

    def layer(entry):
        out = {k: drop(v) for k, v in entry["mixer"].items()}
        if "cross_kv" in entry:
            out["cross_kv"] = {k: drop(v)
                               for k, v in entry["cross_kv"].items()}
        return out

    plen = len(stacked)
    return [layer(stacked[f"pos{l % plen}"]) for l in range(n_layers)]


# --- batch sharding ---------------------------------------------------------

def batch_axes_for(batch_tree) -> Any:
    def axes(name: str, ndim: int):
        if name in ("tokens", "labels", "frames", "encoder_embeddings"):
            return ("batch",) + (None,) * (ndim - 1)
        if name == "pos":
            return ()
        return (None,) * ndim

    def rec(tree):
        return {k: rec(v) if isinstance(v, dict)
                else axes(str(k), len(v.shape)) for k, v in tree.items()}
    return rec(batch_tree)


def batch_shardings(batch_tree, mesh, rules: Dict[str, Any]):
    return tree_shardings(batch_axes_for(batch_tree), mesh, rules, batch_tree)
