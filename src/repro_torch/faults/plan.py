"""Declarative, seeded fault plans (the deterministic fault model).

A :class:`FaultPlan` is a serializable description of transport-level
failures to inject into a scenario run: which fault ``kind``, which
rank it targets, how aggressively, and over which window of exchanges.
Plans are *pure data* — all randomness lives in one
``random.Random(plan.seed)`` stream owned by the injector
(:mod:`repro_torch.faults.inject`), so the same ``(scenario, seed, plan)``
triple produces a byte-identical faulted trace, replayable and
diffable exactly like a healthy one.

Fault kinds (``KINDS``) and the defect class each one seeds:

  * ``drop``       — arrivals vanish in flight: their posted receives
    stall forever (detector ``orphan_posts``).
  * ``duplicate``  — an arrival is delivered twice: the second copy
    parks on the UMQ with no post to claim it (``duplicate_match``).
  * ``reorder``    — arrivals are permuted within a bounded
    displacement ``k``: late receives dig through ``k`` strangers to
    find their message (``reorder_inflation``).
  * ``delay``      — one straggler rank's messages are held back
    ``hold`` exchanges before delivery (``straggler_rank``).
  * ``rank_leave`` — a rank dies mid-run: it stops posting and its
    in-flight traffic never lands (``straggler_rank`` +
    ``orphan_posts`` on its peers).
  * ``rank_join``  — a fresh rank joins mid-run with a trickle of
    warm-up traffic (``straggler_rank`` flags the cold lane; the
    elastic-mesh shapes come from the (data, model) factorization in
    ``workloads.scenarios.elastic_ranks``).

A copy of ``repro.faults.plan``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence, Tuple

KINDS = ("drop", "duplicate", "reorder", "delay", "rank_leave",
         "rank_join")

PLAN_FORMAT = "repro.faults.plan"
PLAN_VERSION = 1


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault, one window.

    ``rank`` scopes the fault: for ``drop``/``duplicate`` it restricts
    the candidate arrivals to those *sent by* ``rank`` (``-1`` = any
    sender); for ``delay``/``rank_leave``/``rank_join`` it names the
    straggler/leaver/joiner. ``rate`` is the per-candidate injection
    probability for ``drop``/``duplicate`` (ignored elsewhere). ``k``
    bounds the reorder displacement. ``hold`` is how many exchanges a
    delayed arrival is deferred. ``every`` spaces the joiner's warm-up
    traffic (one balanced round-trip every ``every``-th exchange).
    ``start``/``stop`` bound the affected exchange indices
    (``stop=-1`` = until the end of the run)."""

    kind: str
    rank: int = -1
    rate: float = 0.0
    k: int = 0
    hold: int = 1
    every: int = 4
    start: int = 0
    stop: int = -1

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} outside [0, 1]")
        if self.kind == "reorder" and self.k < 1:
            raise ValueError("reorder needs displacement bound k >= 1")
        if self.kind == "delay" and self.hold < 1:
            raise ValueError("delay needs hold >= 1 exchanges")
        if self.kind in ("delay", "rank_leave", "rank_join") \
                and self.rank < 0:
            raise ValueError(f"{self.kind} needs a target rank")
        if self.kind == "rank_join" and self.every < 1:
            raise ValueError("rank_join needs every >= 1")

    def active(self, x: int) -> bool:
        """Is this spec live at exchange index ``x``?"""
        return x >= self.start and (self.stop < 0 or x < self.stop)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, obj: Dict) -> "FaultSpec":
        return cls(**{f.name: obj.get(f.name, f.default)
                      for f in dataclasses.fields(cls)})


def _windows_overlap(a: FaultSpec, b: FaultSpec) -> bool:
    """Do two specs' exchange-index windows intersect? ``stop=-1``
    means until the end of the run."""
    a_stop = float("inf") if a.stop < 0 else a.stop
    b_stop = float("inf") if b.stop < 0 else b.stop
    return a.start < b_stop and b.start < a_stop


def _ranks_overlap(a: FaultSpec, b: FaultSpec) -> bool:
    return a.rank < 0 or b.rank < 0 or a.rank == b.rank


def validate_specs(specs: Sequence[FaultSpec]) -> None:
    """Composite-plan window validation: reject spec pairs whose
    combination is ambiguous rather than adversarial-but-legal.

    Two specs of the *same* kind may not overlap in both window and
    rank scope (the injector would double-draw from one candidate
    stream), and a ``rank_leave`` window may not overlap any other
    spec that targets the same rank — a dead rank cannot also
    straggle, rejoin, or send droppable traffic."""
    for i, a in enumerate(specs):
        for b in specs[i + 1:]:
            if not _windows_overlap(a, b):
                continue
            if a.kind == b.kind and _ranks_overlap(a, b):
                raise ValueError(
                    f"composite plan has two overlapping {a.kind!r} "
                    f"specs (windows [{a.start},{a.stop}) and "
                    f"[{b.start},{b.stop}) with intersecting rank "
                    "scope); split the windows or merge the specs")
            for dead, other in ((a, b), (b, a)):
                if dead.kind == "rank_leave" and other.rank >= 0 \
                        and other.rank == dead.rank:
                    raise ValueError(
                        f"rank_leave(rank={dead.rank}) overlaps a "
                        f"{other.kind!r} spec targeting the same "
                        "rank: a dead rank cannot also be a fault "
                        "target — disjoint windows required")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered set of :class:`FaultSpec` plus the injector seed."""

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "specs", tuple(self.specs))
        validate_specs(self.specs)

    def active(self, x: int) -> List[FaultSpec]:
        return [s for s in self.specs if s.active(x)]

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({s.kind for s in self.specs}))

    def to_dict(self) -> Dict:
        return {"format": PLAN_FORMAT, "version": PLAN_VERSION,
                "seed": self.seed,
                "specs": [s.to_dict() for s in self.specs]}

    @classmethod
    def from_dict(cls, obj: Dict) -> "FaultPlan":
        if obj.get("format", PLAN_FORMAT) != PLAN_FORMAT:
            raise ValueError(f"not a fault plan: "
                             f"format={obj.get('format')!r}")
        return cls(specs=tuple(FaultSpec.from_dict(s)
                               for s in obj.get("specs", ())),
                   seed=obj.get("seed", 0))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))


def single(kind: str, seed: int = 0, **kw) -> FaultPlan:
    """One-spec plan: ``single("drop", rate=0.2)``."""
    return FaultPlan(specs=(FaultSpec(kind=kind, **kw),), seed=seed)


# The canonical one-fault-per-kind plans the scenario sweep's fault
# axis runs (workloads.bench / benchmarks/scenario_sweep.py --faults).
# Scenario-agnostic on purpose: rank 1 exists in every gallery
# scenario, the joiner rank is far outside every gallery rank range,
# and windows are expressed in exchange indices so the same plan
# stresses a 5-exchange smoke run and a 50-exchange full run.
JOINER_RANK = 97

_DEFAULTS: Dict[str, FaultSpec] = {
    "drop": FaultSpec(kind="drop", rate=0.15),
    "duplicate": FaultSpec(kind="duplicate", rate=0.15),
    "reorder": FaultSpec(kind="reorder", k=16),
    "delay": FaultSpec(kind="delay", rank=1, hold=2),
    # leave almost immediately: the dead rank's lane freezes near zero
    "rank_leave": FaultSpec(kind="rank_leave", rank=1, start=2),
    # a light warm-up trickle: the joiner's lane stays cold vs peers
    "rank_join": FaultSpec(kind="rank_join", rank=JOINER_RANK,
                           every=6, start=1),
}


def default_plan(kind: str, seed: int = 0) -> FaultPlan:
    """The sweep's canonical single-kind plan for ``kind``."""
    try:
        spec = _DEFAULTS[kind]
    except KeyError:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"expected one of {KINDS}") from None
    return FaultPlan(specs=(spec,), seed=seed)


def plans(seed: int = 0) -> Dict[str, FaultPlan]:
    """All canonical single-kind plans, keyed by kind."""
    return {k: default_plan(k, seed=seed) for k in KINDS}


# The canonical composite (multi-kind) plans the sweep's
# ``--faults composite`` axis runs. Kind pairs are chosen so their
# counter signatures do not cancel: drop's net orphans and delay's
# deferred-lag evidence are disjoint, as are duplicate's UMQ residue
# and reorder's traversal-depth tail. (drop+duplicate would be a bad
# composite — orphans and residue net against each other in the
# detector algebra, masking both.) Composite names join their member
# kinds with ``+``, which no single kind contains, so sweep cell keys
# stay unambiguous.
_COMPOSITES: Dict[str, Tuple[str, ...]] = {
    "drop+delay": ("drop", "delay"),
    "duplicate+reorder": ("duplicate", "reorder"),
}


def composite_plan(name: str, seed: int = 0) -> FaultPlan:
    """The canonical composite plan ``name`` (see ``composite_names``)."""
    try:
        kinds = _COMPOSITES[name]
    except KeyError:
        raise ValueError(
            f"unknown composite plan {name!r}; expected one of "
            f"{tuple(_COMPOSITES)}") from None
    return FaultPlan(specs=tuple(_DEFAULTS[k] for k in kinds),
                     seed=seed)


def composite_names() -> Tuple[str, ...]:
    return tuple(_COMPOSITES)


def composite_kinds(name: str) -> Tuple[str, ...]:
    """The member kinds of canonical composite ``name``."""
    try:
        return _COMPOSITES[name]
    except KeyError:
        raise ValueError(f"unknown composite plan {name!r}") from None


def composite_plans(seed: int = 0) -> Dict[str, FaultPlan]:
    """All canonical composite plans, keyed by name."""
    return {n: composite_plan(n, seed=seed) for n in _COMPOSITES}
