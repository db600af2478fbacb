"""Scenario substrate: declarative, seeded communication-pattern
generators (the "as many scenarios as you can imagine" axis).

A :class:`Scenario` is a named, parameterized description of one
communication pattern. Its ``drive`` callable sends the pattern's
traffic through a :class:`repro_torch.match.Fabric` — collectives, raw
exchanges or direct per-engine post/arrive calls — using only a seeded
``random.Random`` for any randomness, so the generated op stream (and
therefore the trace, the match order and every queue-shape counter) is a
pure function of ``(scenario, params, seed)``. That determinism is what
makes scenario runs diffable run-to-run and regression-gateable against
a committed baseline.

Every scenario also declares which queue/path it stresses and which
detector is expected to fire under which seeded defect
(``expect``) — the scenario gallery in the README is generated from
these declarations, and the bench harness checks them.

Progress-engine lanes: scenarios additionally carry a deterministic
submit/process schedule (:func:`progress_schedule`) modeling the user
thread enqueueing requests faster than one processing quantum drains
them. The harness feeds that schedule through
:func:`repro_torch.trace.replay_progress` under either queue discipline, so
the §4 shared-queue defect is exercised — and flagged by
``contention`` — in every scenario without wall-clock-dependent
threading. (Live threaded runs of :class:`repro_torch.comm.progress
.ProgressEngine` remain available via ``examples/timeline_tour.py``.)

A copy of ``repro.workloads.base``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Tuple

from ..match import Fabric

# the three seeded defects the suite must surface, and the detector kind
# expected to flag each (engine modes for the first two, the progress
# queue discipline for the third)
DEFECT_DETECTOR = {
    "linear": "long_traversal",
    "leaky_umq": "umq_flood",
    "shared": "contention",
}

Params = Dict[str, int]
Drive = Callable[[Fabric, random.Random, Params], None]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative communication-pattern generator.

    ``expect`` maps a seeded-defect name (``linear`` / ``leaky_umq`` /
    ``shared``) to True when this scenario's traffic is adversarial
    enough that the matching detector must fire under that defect (the
    bench harness enforces it; ``shared`` is stressed by every scenario
    through the progress-lane schedule). ``smoke`` overrides ``defaults``
    for CI-sized runs."""

    name: str
    description: str
    stresses: str
    drive: Drive
    defaults: Params
    smoke: Params = dataclasses.field(default_factory=dict)
    expect: Tuple[str, ...] = ("shared",)
    # fault kinds (repro_torch.faults.KINDS) whose canonical injected plan
    # this scenario's traffic must make detectable — the sweep's fault
    # axis enforces FAULT_DETECTOR[kind] fires in the faulted cell
    fault_expect: Tuple[str, ...] = ()
    # fabric knobs (deterministic unexpected/wildcard mix)
    unexpected_every: int = 3
    wildcard_every: int = 4

    def params(self, size: str = "full", **overrides) -> Params:
        p = dict(self.defaults)
        if size == "smoke":
            p.update(self.smoke)
        elif size != "full":
            raise ValueError(f"unknown size {size!r} "
                             "(expected 'full' or 'smoke')")
        p.update(overrides)
        return p

    def run(self, fabric: Fabric, seed: int = 0,
            params: Optional[Params] = None) -> None:
        """Drive the pattern through ``fabric`` with a fresh seeded rng."""
        self.drive(fabric, random.Random(seed), params or self.params())


_REGISTRY: Dict[str, Scenario] = {}


def register(s: Scenario) -> Scenario:
    if s.name in _REGISTRY:
        raise ValueError(f"scenario {s.name!r} already registered")
    _REGISTRY[s.name] = s
    return s


def scenario(name: str, description: str, stresses: str,
             defaults: Params, smoke: Optional[Params] = None,
             expect: Tuple[str, ...] = ("shared",),
             fault_expect: Tuple[str, ...] = (),
             unexpected_every: int = 3,
             wildcard_every: int = 4) -> Callable[[Drive], Drive]:
    """Decorator form: ``@scenario("halo3d", ..., defaults={...})`` over
    the drive function registers the scenario and returns the function
    unchanged."""
    def wrap(drive: Drive) -> Drive:
        register(Scenario(
            name=name, description=description, stresses=stresses,
            drive=drive, defaults=defaults, smoke=smoke or {},
            expect=expect, fault_expect=fault_expect,
            unexpected_every=unexpected_every,
            wildcard_every=wildcard_every))
        return drive
    return wrap


def get(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {names()}") from None


def names() -> List[str]:
    return sorted(_REGISTRY)


def all_scenarios() -> List[Scenario]:
    return [_REGISTRY[n] for n in names()]


# -- deterministic progress-engine lane schedule ---------------------------

def progress_schedule(rng: random.Random, n_requests: int,
                      gap_ns: Tuple[int, int] = (1_500, 3_000),
                      dur_ns: Tuple[int, int] = (8_000, 12_000)
                      ) -> List[Dict]:
    """A seeded submit/process stream in the trace's ``pe`` record
    encoding: submits arrive every ``gap_ns`` while each processing
    quantum costs ``dur_ns`` — gaps shorter than quanta, so requests pile
    up and the shared-queue discipline serializes submits behind whole
    quanta (paper Fig. 10). Durations stay within a 1.5x band so the
    ``irregular`` detector has nothing to say about the healthy model."""
    out: List[Dict] = []
    t = 0
    for _ in range(n_requests):
        t += rng.randint(*gap_ns)
        out.append({"t": "pe", "ev": "submit", "ts": t, "wait": 0})
        out.append({"t": "pe", "ev": "proc", "ts": t,
                    "dur": rng.randint(*dur_ns)})
    return out
