"""COMB analog: 3-D halo exchange + stencil on a single-controller mesh.

Port of ``repro.comm.halo``. COMB (paper §2.3) explores
communication-pattern tradeoffs for structured mesh halo exchanges:
blocking vs non-blocking, staging buffers, message sizes. The axes of
that design space kept here:

  * variant="blocking"  — exchange all faces, *then* compute the stencil
    (the exchange is fully exposed; COMB's waitall-before-compute).
  * variant="overlap"   — compute the interior stencil while faces are in
    flight; apply boundary columns afterwards.
  * width, box          — message size sweep (COMB's size sweeps).

Regions are named after COMB's own Caliper annotations (pre-comm,
post-send, wait-recv, post-comm, ...) so the comparison trees read like
the paper's Figures 1-3.

A sharded field is the stack of its ranks' blocks (:mod:`.mesh`): on a
2 x 2 x 2 mesh, (2, 2, 2, bx, by, bz). The stencil acts on the last three
dimensions, so the same code serves one block and the stack. On one card
an exchanged face is a device-to-device copy (:func:`.collectives.
ppermute`): there is no wire, so exchange time is copies and host
scheduling. The 7-point stencil is plain PyTorch, as the reference's is
plain jnp (no Pallas kernel). Where the reference fences with
``jax.block_until_ready``, the port waits for the card's current stream
(:func:`repro_torch.device.fence`); the blocking variant's
``optimization_barrier`` is such a wait too.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import regions
from ..device import fence
from . import patterns
from .collectives import comm_phase, ppermute
from .mesh import Mesh, axis_size, shard_map

_AXIS = {"x": 0, "y": 1, "z": 2}


def _shift(x: torch.Tensor, axis_name: str, direction: int,
           ax: int = 0) -> torch.Tensor:
    n = axis_size(axis_name)
    # perm + envelope tag per (mesh axis position, direction) come from
    # comm.patterns so the matching engine and the offline workload
    # scenarios see the exact message streams the stencil issues
    return ppermute(x, axis_name, patterns.ring_perm(n, direction),
                    tag=patterns.halo_tag(ax, direction))


def stencil_interior(u: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian on the local block(s): the last three dimensions
    (interior only; edges wrong until halos are applied)."""
    return (
        -6.0 * u
        + torch.roll(u, 1, -3) + torch.roll(u, -1, -3)
        + torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
        + torch.roll(u, 1, -1) + torch.roll(u, -1, -1)
    )


def _face(arr: torch.Tensor, ax: int, w: int, front: bool) -> torch.Tensor:
    dim = ax - 3
    return arr.narrow(dim, 0 if front else arr.shape[dim] - w, w)


def _wrapped_face(u: torch.Tensor, ax: int, w: int, front: bool
                  ) -> torch.Tensor:
    """The face of ``torch.roll(u, 1 if front else -1, ax - 3)``: what the
    rolled stencil used where the halo belongs. Gathered from ``u``
    directly; rolling the whole block to take one face would copy it
    (the reference's jitted roll-then-slice computes only the face)."""
    dim = ax - 3
    n = u.shape[dim]
    start = 0 if front else n - w
    idx = (torch.arange(start, start + w, device=u.device)
           - (1 if front else -1)) % n
    return u.index_select(dim, idx)


def _faces(u: torch.Tensor, axis_names, w: int
           ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    return {name: (_face(u, _AXIS[name], w, True),
                   _face(u, _AXIS[name], w, False)) for name in axis_names}


def _exchange(faces, axis_names) -> Dict[str, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    halos = {}
    with comm_phase("halo_exchange"):
        for i, name in enumerate(axis_names):
            lo_face, hi_face = faces[name]
            # receive the neighbor's hi face as my lo halo and vice versa
            halos[name] = (
                _shift(hi_face, name, +1, ax=i),
                _shift(lo_face, name, -1, ax=i),
            )
    return halos


def _apply_halos(out, u, halos, width: int):
    """Fix the wrap-around faces of the rolled stencil with true halos.
    Writes into ``out`` (the stencil's own result) and returns it, where
    the reference builds a new array with ``.at[].set``."""
    w = width
    for axis, (lo, hi) in halos.items():
        ax = _AXIS[axis]
        for front, halo in ((True, lo), (False, hi)):
            # replace the wrong wrap contribution with the neighbor's face
            wrong = _wrapped_face(u, ax, w, front)
            face = _face(out, ax, w, front)
            face.copy_(face - wrong + halo)
    return out


def halo_step(u: torch.Tensor, axis_names=("x", "y", "z"), width: int = 1,
              variant: str = "overlap") -> torch.Tensor:
    """One stencil step with halo exchange on the stacked blocks (inside
    :func:`.mesh.shard_map`)."""
    w = width

    with regions.annotate("bench_comm", category="app"):
        with regions.annotate("pre-comm", category="api"):
            faces = _faces(u, axis_names, w)

        with regions.annotate("post-send", category="api"):
            halos = _exchange(faces, axis_names)

        if variant == "blocking":
            with regions.annotate("wait-recv", category="api"):
                # one queue: pin compute behind the completed exchange
                fence(halos, u)
            with regions.annotate("post-comm", category="api"):
                out = stencil_interior(u)
                out = _apply_halos(out, u, halos, w)
        else:
            with regions.annotate("post-comm", category="api"):
                # second queue: interior stencil runs while faces fly
                out = stencil_interior(u)
            with regions.annotate("wait-recv", category="api"):
                out = _apply_halos(out, u, halos, w)
    return out


def make_halo_fn(mesh: Mesh, width: int = 1, variant: str = "overlap",
                 steps: int = 1):
    """Multi-step halo/stencil program over a 3-D mesh: takes and returns
    the stacked blocks."""
    axes = mesh.axis_names

    def local(u):
        for _ in range(steps):
            u = halo_step(u, axis_names=axes, width=width, variant=variant)
        return u

    return shard_map(local, mesh=mesh)


class HaloProgram:
    """Segmented halo program for *measured* host profiling.

    All backends share the exact same region structure (as COMB's regions
    are identical whichever MPI library is linked); only the
    implementation behind each segment differs:

      explicit=True   face copies by ppermute on the stacked blocks
                      (ExaMPI analog)
      explicit=False  the global field rolled by torch.roll, the library
                      choosing how to move the data (vendor analog)

    ``run`` and ``step`` take and return the stacked blocks
    (``mesh.shard(field)``) for both. The reference runs each segment
    under ``jax.jit``, so the regions inside a segment (``ppermute(x)``
    under ``post-send``) fire once per compile; the port runs eagerly and
    they fire on every call.

    The communication segment can be dispatched through a
    :class:`repro_torch.comm.progress.ProgressEngine` — mode "shared"
    reproduces the paper's one-queue lock contention; mode "incoming" is
    the second-queue fix. ``fence_every_op`` reproduces §3's
    host-scheduling defect (even compute-only regions slow down).
    """

    def __init__(self, mesh: Mesh, width: int = 1, explicit: bool = True):
        self.mesh = mesh
        self.width = width
        axes = mesh.axis_names
        w = width

        def extract(u):
            return _faces(u, axes, w)

        def exchange(faces):
            return _exchange(faces, axes)

        def boundary(out, u, halos):
            return _apply_halos(out, u, halos, w)

        self.extract = shard_map(extract, mesh=mesh)
        if explicit:
            self.exchange = shard_map(exchange, mesh=mesh)
            self.interior = shard_map(stencil_interior, mesh=mesh)
            self.boundary = shard_map(boundary, mesh=mesh)
        else:
            # vendor variant: the global roll IS the complete periodic
            # answer, and the data movement it takes (the field assembled
            # and cut again) hides inside the compute segment — the
            # vendor-black-box property. The comm-specific segments are
            # structurally present but trivially cheap.
            def exchange_noop(u):
                return {}

            def interior_global(u):
                return mesh.shard(stencil_interior(mesh.unshard(u)))

            def boundary_noop(out, u, halos):
                return out

            self.exchange = exchange_noop
            self.interior = interior_global
            self.boundary = boundary_noop
        self._exchange_takes_u = not explicit

    def step(self, u, engine=None, fence_every_op: bool = False):
        def fenced(x):
            if fence_every_op:
                fence(x)
            return x

        with regions.annotate("bench_comm", category="app"):
            with regions.annotate("pre-comm", category="api"):
                faces = fenced(self.extract(u))
            with regions.annotate("post-send", category="api"):
                arg = u if self._exchange_takes_u else faces
                if engine is not None:
                    req = self.exchange_request = engine.submit(
                        self.exchange, arg)
                    halos = None
                else:
                    halos = fenced(self.exchange(arg))
            with regions.annotate("post-comm", category="api"):
                # compute-only region: always fenced so every backend's
                # tree charges its stencil cost here (the engine's
                # exchange still progresses concurrently on its thread)
                out = self.interior(u)
                fence(out)
            with regions.annotate("wait-recv", category="collective"):
                if engine is not None:
                    halos = req.wait()
                else:
                    fence(halos)
            with regions.annotate("post-recv", category="api"):
                out = fenced(self.boundary(out, u, halos))
        return out

    def run(self, u, steps: int, engine=None, fence_every_op: bool = False):
        for s in range(steps):
            with regions.annotate(f"cycle_{s}", category="app"):
                u = self.step(u, engine=engine,
                              fence_every_op=fence_every_op)
        with regions.annotate("wait-send", category="collective"):
            fence(u)
        return u


def make_xla_auto_fn(mesh: Mesh, width: int = 1, steps: int = 1):
    """The 'vendor' implementation: plain torch.roll on the global field
    (the stacked blocks assembled, rolled and cut again), the library
    choosing how to move the data (Spectrum-MPI analog). Takes and returns
    the stacked blocks."""

    def step(u):
        with regions.annotate("bench_comm", category="app"):
            with regions.annotate("post-comm", category="api"):
                g = mesh.unshard(u)
                return mesh.shard(
                    -6.0 * g
                    + torch.roll(g, 1, 0) + torch.roll(g, -1, 0)
                    + torch.roll(g, 1, 1) + torch.roll(g, -1, 1)
                    + torch.roll(g, 1, 2) + torch.roll(g, -1, 2)
                )

    def run(u):
        for _ in range(steps):
            u = step(u)
        return u

    return run
