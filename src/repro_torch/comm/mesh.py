"""Single-controller device mesh: the port's counterpart of
``repro.core.compat``'s ``make_mesh``, ``shard_map`` and ``axis_size``.

The JAX comm layer is single-controller SPMD: one process drives a device
mesh through ``shard_map``, and a collective is an operation over a mesh
axis. The port keeps that shape on one device. A sharded array is held as
the stack of its local blocks, with the mesh axes as leading dimensions:
a global (X, Y, Z) array on a 2 x 2 x 2 mesh is a (2, 2, 2, X/2, Y/2, Z/2)
tensor, block (i, j, k) being rank (i, j, k)'s shard. A collective over a
mesh axis is an operation along that axis's dimension
(:mod:`repro_torch.comm.collectives`); on the card a ``ppermute`` is a
device-to-device copy of the blocks, with no wire in between.

No rank lives in a process of its own, and this is not
``torch.distributed``: NCCL puts no two ranks on one card, and one
controller feeds the matching fabric once per dispatch, as the JAX
package's does.

    mesh = Mesh((2, 2, 2), ("x", "y", "z"), device="cuda")
    u = mesh.shard(global_field)                # (2, 2, 2, bx, by, bz)
    out = shard_map(local_fn, mesh=mesh)(u)     # collectives see the mesh
    field = mesh.unshard(out)
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Iterator, Sequence, Tuple

import torch

_tls = threading.local()


class Mesh:
    """``dims`` ranks along each of the named axes, every block on
    ``device``."""

    def __init__(self, dims: Sequence[int], axis_names: Sequence[str],
                 device="cpu"):
        if len(dims) != len(axis_names) or any(d < 1 for d in dims):
            raise ValueError(f"bad mesh {tuple(dims)} {tuple(axis_names)}")
        self.dims: Tuple[int, ...] = tuple(int(d) for d in dims)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.device = torch.device(device)
        self.shape = dict(zip(self.axis_names, self.dims))

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def dim(self, axis_name: str) -> int:
        """The stacked dimension of mesh axis ``axis_name``."""
        if axis_name not in self.shape:
            raise ValueError(f"no mesh axis {axis_name!r} in "
                             f"{self.axis_names}")
        return self.axis_names.index(axis_name)

    def axis_size(self, axis_name: str) -> int:
        return self.shape[axis_name]

    def axis_index(self, axis_name: str) -> torch.Tensor:
        """Each rank's position along ``axis_name``: an int64 tensor of the
        mesh's shape (``jax.lax.axis_index`` seen from every rank)."""
        d = self.dim(axis_name)
        view = [1] * self.ndim
        view[d] = self.dims[d]
        return torch.arange(self.dims[d], device=self.device).view(
            view).expand(self.dims)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """Cut global ``x``'s leading ``ndim`` dimensions over the mesh
        (``NamedSharding(mesh, P(*axis_names))``): returns the stacked
        blocks (``dims + block shape``) on the mesh's device."""
        nd = self.ndim
        if x.dim() < nd or any(n % d for n, d in zip(x.shape, self.dims)):
            raise ValueError(f"shape {tuple(x.shape)} does not divide over "
                             f"mesh {self.dims}")
        split = []
        for n, d in zip(x.shape, self.dims):
            split += [d, n // d]
        y = x.to(self.device).reshape(*split, *x.shape[nd:])
        order = ([2 * i for i in range(nd)] + [2 * i + 1 for i in range(nd)]
                 + list(range(2 * nd, y.dim())))
        return y.permute(order).contiguous()

    def unshard(self, stacked: torch.Tensor) -> torch.Tensor:
        """The global array of stacked blocks (the inverse of
        :meth:`shard`, ``out_specs=P(*axis_names)``)."""
        nd = self.ndim
        if tuple(stacked.shape[:nd]) != self.dims:
            raise ValueError(f"stacked shape {tuple(stacked.shape)} does not "
                             f"lead with mesh {self.dims}")
        order = []
        for i in range(nd):
            order += [i, nd + i]
        order += list(range(2 * nd, stacked.dim()))
        y = stacked.permute(order)
        return y.reshape(*(d * n for d, n in zip(
            self.dims, stacked.shape[nd:2 * nd])), *stacked.shape[2 * nd:])

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """The same ``x`` on every rank (``P(None, ...)``): stacked blocks
        of ``dims + x.shape``."""
        return x.to(self.device).expand(*self.dims, *x.shape).contiguous()

    @contextlib.contextmanager
    def active(self) -> Iterator["Mesh"]:
        """Make this the mesh that collectives and :func:`axis_size` see,
        as ``shard_map`` binds its mesh's axis names."""
        stack = _stack()
        stack.append(self)
        try:
            yield self
        finally:
            stack.pop()

    def __repr__(self) -> str:
        return f"Mesh({self.dims}, {self.axis_names}, device={self.device})"


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_mesh() -> Mesh:
    """The mesh of the innermost :func:`shard_map` (or
    :meth:`Mesh.active`) on this thread; raise outside one."""
    st = _stack()
    if not st:
        raise RuntimeError("no active mesh: collectives run inside "
                           "shard_map(fn, mesh=...) or mesh.active()")
    return st[-1]


def shard_map(f: Callable, *, mesh: Mesh) -> Callable:
    """``f`` run with ``mesh`` active, on whichever thread calls it.
    ``f`` takes and returns stacked blocks; inside it, collectives act
    along the mesh's dimensions."""

    @functools.wraps(f)
    def run(*args, **kwargs):
        with mesh.active():
            return f(*args, **kwargs)

    return run


def axis_size(axis_name: str) -> int:
    """Size of a mesh axis of the active mesh."""
    return current_mesh().axis_size(axis_name)


def axis_index(axis_name: str) -> torch.Tensor:
    """Each rank's position along ``axis_name`` in the active mesh."""
    return current_mesh().axis_index(axis_name)
