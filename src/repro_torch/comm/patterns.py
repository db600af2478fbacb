"""Pure communication-pattern generators (JAX-free).

One source of truth for the (src, dst) pair lists and envelope-tag
conventions the repo's communication patterns are built from, shared by

  * the live comm layer — :mod:`repro_torch.comm.ring` ring schedules and
    :mod:`repro_torch.comm.halo` face shifts running under shard_map,
  * the matching fabric — :meth:`repro_torch.match.Fabric` collective
    decompositions, and
  * the workload scenario suite — :mod:`repro.workloads`, which drives
    the fabric offline with the same patterns the JAX workloads dispatch,

so a scenario named ``halo3d`` exercises byte-for-byte the message
streams the real halo stencil generates. Keeping this module free of JAX
imports is what lets the scenario suite and the trace replayer stay
offline-runnable.

A copy of ``repro.comm.patterns``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import random
from functools import lru_cache
from typing import Dict, Sequence, Tuple

Pair = Tuple[int, int]

AXIS_INDEX = {"x": 0, "y": 1, "z": 2}

# The deterministic generators below are memoized and return immutable
# tuples: collective decompositions rebuild the same pair lists once per
# ring step / halo face, which at matching-engine throughput is real
# per-op overhead. Callers iterate (or copy) — never mutate.


@lru_cache(maxsize=None)
def ring_perm(n: int, step: int = 1) -> Sequence[Pair]:
    """The ring permutation ``i -> (i + step) % n`` (step -1 reverses)."""
    return tuple((i, (i + step) % n) for i in range(n))


def halo_tag(axis: int, direction: int) -> int:
    """Envelope tag for one halo face shift: one tag per (mesh axis,
    direction), so the matching engine sees each face as a distinct
    message stream (the convention :func:`repro_torch.comm.halo._shift`
    stamps on its ppermutes)."""
    return 2 * axis + (1 if direction > 0 else 0)


@lru_cache(maxsize=None)
def halo_shifts(n: int, axes: int = 3) -> Sequence[
        Tuple[int, int, Sequence[Pair], int]]:
    """All face shifts of one halo-exchange step on ``axes`` ring axes of
    size ``n``: ``(axis, direction, perm, tag)`` in the fixed axis-major
    order the stencil issues them."""
    return tuple((ax, direction, ring_perm(n, direction),
                  halo_tag(ax, direction))
                 for ax in range(axes) for direction in (1, -1))


@lru_cache(maxsize=None)
def transpose_pairs(n: int) -> Sequence[Pair]:
    """Full all-to-all (matrix transpose) traffic: every ordered pair."""
    return tuple((i, j) for i in range(n) for j in range(n) if i != j)


@lru_cache(maxsize=None)
def _peers(n: int, src: int) -> Sequence[int]:
    return tuple(d for d in range(n) if d != src)


# -- rng-bound stream memoization ------------------------------------------
#
# The two rng-bound generators below consume a ``random.Random`` stream
# whose exact call sequence is part of the scenario suite's determinism
# contract: committed golden traces and baselines pin the resulting op
# streams byte-for-byte, so the Mersenne-Twister draws can never be
# re-expressed as numpy ``Generator`` batches (a different bit generator
# produces a different stream). What *can* be removed is the per-op
# python cost of re-deriving the same stream every drive: results are
# memoized keyed on the rng's full state, and a cache hit fast-forwards
# the rng to the recorded end state instead of replaying the draws.
# Identical inputs + identical rng state -> identical pairs AND
# identical post-call rng state, so the contract holds bit-for-bit
# while the steady-state generation cost collapses to one state hash.

_STREAM_CACHE: Dict = {}
_STREAM_CACHE_MAX = 512


def _stream_memo(key, rng: random.Random, build):
    state = rng.getstate()
    hit = _STREAM_CACHE.get((key, state))
    if hit is not None:
        value, end = hit
        rng.setstate(end)
        return value
    value = build()
    if len(_STREAM_CACHE) >= _STREAM_CACHE_MAX:
        _STREAM_CACHE.clear()
    _STREAM_CACHE[(key, state)] = (value, rng.getstate())
    return value


def random_neighbor_pairs(n: int, degree: int,
                          rng: random.Random) -> Sequence[Pair]:
    """Sparse random neighbor exchange: each rank sends to ``degree``
    distinct random peers (seeded — same rng state, same graph; the
    rng consumption order is part of the scenario suite's determinism
    contract)."""
    pairs = []
    for src in range(n):
        peers = _peers(n, src)
        for dst in rng.sample(peers, min(degree, len(peers))):
            pairs.append((src, dst))
    return tuple(pairs)


def random_neighbor_rounds(n: int, degree: int, rounds: int,
                           rng: random.Random) -> Sequence[Sequence[Pair]]:
    """A whole drive's worth of :func:`random_neighbor_pairs` rounds,
    state-memoized as one stream: one rng-state hash per drive replaces
    ``rounds * n`` sampler calls, and the interned per-round tuples are
    what the fabric's exchange-plan cache keys on."""
    return _stream_memo(
        ("sparse", n, degree, rounds), rng,
        lambda: tuple(random_neighbor_pairs(n, degree, rng)
                      for _ in range(rounds)))


def power_law_rounds(n: int, rounds: int, base_bytes: int,
                     rng: random.Random
                     ) -> Sequence[Tuple[Sequence[Pair], int]]:
    """A whole drive's worth of ``power_law_burst`` rounds: per round
    ``(pairs, nbytes)``, where every peer fans a heavy-tailed (capped)
    batch into the round's hot rank ``r % n`` and the payload size is
    power-law drawn. State-memoized as one stream (see above)."""
    def build() -> Sequence[Tuple[Sequence[Pair], int]]:
        out = []
        for r in range(rounds):
            hot = r % n
            pairs = []
            for src in range(n):
                if src == hot:
                    continue
                # heavy-tailed per-sender batch, capped so a healthy
                # burst stays well under the umq_flood threshold
                m = min(1 + int(rng.paretovariate(1.2)), 4)
                pairs.extend([(src, hot)] * m)
            nb = min(base_bytes * (1 << int(rng.paretovariate(1.0))),
                     1 << 20)
            out.append((tuple(pairs), nb))
        return tuple(out)
    return _stream_memo(("power_law", n, rounds, base_bytes), rng, build)


@lru_cache(maxsize=None)
def reversed_pairs(pairs: Sequence[Pair]) -> Sequence[Pair]:
    """The same pairs in reversed order (the adversarial delivery
    permutation the transpose scenario posts against). Memoized on the
    (immutable) input tuple so repeated rounds reuse one interned
    object — which is what lets the fabric's exchange-plan cache key
    delivery permutations by identity."""
    return tuple(reversed(pairs))


@lru_cache(maxsize=None)
def swap_pairs(pairs: Sequence[Pair]) -> Sequence[Pair]:
    """Each (src, dst) flipped to (dst, src): a fold's matching
    broadcast, a request wave's reply wave."""
    return tuple((d, s) for s, d in pairs)


@lru_cache(maxsize=None)
def fan_in_pairs(n: int, hot: int) -> Sequence[Pair]:
    """Every rank in ``range(n)`` sends one message to ``hot``."""
    return tuple((c, hot) for c in range(n))


@lru_cache(maxsize=None)
def laggard_last(pairs: Sequence[Pair], laggard: int) -> Sequence[Pair]:
    """Delivery permutation holding every pair destined to ``laggard``
    behind all other arrivals (the straggling-client reply shape)."""
    return (tuple(pr for pr in pairs if pr[1] != laggard)
            + tuple(pr for pr in pairs if pr[1] == laggard))


@lru_cache(maxsize=None)
def shifted_ring(base: int, n: int) -> Sequence[Pair]:
    """``ring_perm(n)`` over the contiguous rank block starting at
    ``base`` (one model-parallel mesh group's ring)."""
    return tuple((base + i, base + (i + 1) % n) for i in range(n))


@lru_cache(maxsize=None)
def kripke_diagonals(gx: int, gy: int,
                     corner: int) -> Sequence[Sequence[Pair]]:
    """Wavefront-sweep traffic over a ``gx x gy`` rank grid from one of
    the four sweep corners: one (possibly empty) pair tuple per
    anti-diagonal, in dependency order — each diagonal's sends gate the
    next. ``corner`` rotates through the four quadrants exactly as the
    Kripke-style scenario's ``(cx, cy)`` table does."""
    cx, cy = ((0, 0), (1, 0), (1, 1), (0, 1))[corner % 4]

    def rid(x: int, y: int) -> int:
        return x * gy + y

    diagonals = []
    for d in range(gx + gy - 1):
        pairs = []
        for x in range(gx):
            y = d - x
            if not 0 <= y < gy:
                continue
            ax = gx - 1 - x if cx else x
            ay = gy - 1 - y if cy else y
            nx = ax + (-1 if cx else 1)
            ny = ay + (-1 if cy else 1)
            if 0 <= nx < gx:
                pairs.append((rid(ax, ay), rid(nx, ay)))
            if 0 <= ny < gy:
                pairs.append((rid(ax, ay), rid(ax, ny)))
        diagonals.append(tuple(pairs))
    return tuple(diagonals)


@lru_cache(maxsize=None)
def hot_rank_pairs(n: int, hot: int = 0,
                   per_worker: int = 1) -> Sequence[Pair]:
    """Master–worker imbalance: every other rank sends ``per_worker``
    messages to the single hot rank."""
    return tuple((w, hot) for w in range(n) if w != hot
                 for _ in range(per_worker))


@lru_cache(maxsize=None)
def tree_pairs(n: int, root: int = 0) -> Sequence[Sequence[Pair]]:
    """Binomial reduction tree toward ``root``: one tuple of (src, dst)
    pairs per level, leaves first — level ``s`` folds each surviving
    rank at offset ``2**s`` into its partner, halving the participant
    set until only the root holds the result. Reverse the levels (and
    swap each pair) for the matching broadcast."""
    levels = []
    span = 1
    while span < n:
        level = tuple(((i + span + root) % n, (i + root) % n)
                      for i in range(0, n, span * 2) if i + span < n)
        if level:
            levels.append(level)
        span *= 2
    return tuple(levels)


@lru_cache(maxsize=None)
def butterfly_pairs(n: int) -> Sequence[Sequence[Pair]]:
    """Recursive-doubling butterfly: one tuple of (src, dst) pairs per
    stage; at stage ``s`` every rank exchanges with its partner
    ``i XOR 2**s``. All ranks stay busy every stage (the allreduce
    shape), unlike :func:`tree_pairs` where participation shrinks.
    For non-power-of-two ``n`` the pairs whose partner falls outside
    the set are skipped."""
    stages = []
    d = 1
    while d < n:
        stages.append(tuple((i, i ^ d) for i in range(n) if (i ^ d) < n))
        d *= 2
    return tuple(stages)
