"""Declarative, seeded recovery policies (the self-healing layer).

A :class:`RecoveryPolicy` is pure data, exactly like a
:class:`~repro_torch.faults.plan.FaultPlan`: one :class:`RecoveryRule` per
recoverable fault kind, serializable and validated. The injector
(:class:`repro_torch.faults.inject.FaultyFabric`) applies it through the
same two sanctioned fabric seams the faults themselves use, so the
healing is *real* — the engines match real retransmitted arrivals and
never see a suppressed duplicate:

  * ``drop``       — every dropped delivery is retransmitted after a
    deterministic modeled-tick timeout with exponential backoff; a
    retransmit can itself be lost (bounded by ``max_retries``, after
    which the modeled reliable channel delivers it), so a run with a
    recovering transport always converges to zero net orphan posts.
    Evidence: ``fault.recovery.retransmit`` / ``fault.recovery.retry``
    on the receiver's lane (detectors ``recovered_drop`` /
    ``retry_storm``).
  * ``duplicate``  — receivers track per-channel sequence numbers; the
    injected copy reuses its original's sequence, so the dedup window
    discards it before it can park on the UMQ. Evidence:
    ``fault.recovery.suppressed`` (detector ``suppressed_duplicate``).
  * ``rank_leave`` — once a rank is known dead, peers cancel the
    receives they would have posted for its traffic instead of
    orphaning them. Evidence: ``fault.recovery.cancelled`` (folded
    into ``recovered_drop``).

All recovery randomness (the retransmit jitter and the lost-retransmit
draws) comes from one dedicated stream derived from the *plan's* seed
(:func:`recovery_stream`), kept separate from the injector's fault
stream — enabling recovery never changes which faults fire, so the
healed run is directly comparable to the unhealed one. The same
``(scenario, seed, plan, policy)`` quadruple produces a byte-identical
trace; each recovery action is annotated with a bare ``rcv`` record
that (like ``flt``) streams unchanged through trace conversion, so
``v2 <-> v3`` round-trips stay byte-identical.

A copy of ``repro.faults.recovery``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
from typing import Dict, Optional, Tuple

# Fault kinds a rule may target. reorder needs no recovery (matching
# itself absorbs displaced deliveries), delay heals itself (deferred
# messages land late, not never), and rank_join adds traffic rather
# than losing it.
RECOVERABLE_KINDS = ("drop", "duplicate", "rank_leave")

POLICY_FORMAT = "repro.faults.recovery"
POLICY_VERSION = 1

# Evidence counters the injector records on the affected lanes; the
# recovered_drop / suppressed_duplicate / retry_storm detectors in
# core.analyses key on these names (kept literal there — core must not
# import faults).
EV_RETRANSMIT = "fault.recovery.retransmit"
EV_RETRY = "fault.recovery.retry"
EV_SUPPRESSED = "fault.recovery.suppressed"
EV_CANCELLED = "fault.recovery.cancelled"

# Salt folded into the plan seed for the recovery stream, so the fault
# stream random.Random(plan.seed) is untouched by enabling recovery.
_SEED_SALT = 0x5EC0_77E5


def recovery_stream(plan_seed: int) -> random.Random:
    """The policy's dedicated rng: jitter and lost-retransmit draws
    come from here, never from the injector's fault stream."""
    return random.Random((plan_seed ^ _SEED_SALT) * 2654435761 % (1 << 63))


@dataclasses.dataclass(frozen=True)
class RecoveryRule:
    """How one fault kind is healed.

    ``timeout`` is the modeled-tick (exchange-count) wait before the
    first retransmit of a dropped delivery; attempt ``a`` waits
    ``ceil(timeout * backoff**a)`` plus a jitter tick drawn uniformly
    from ``0..jitter``. ``max_retries`` bounds how many retransmits
    may themselves be lost before the modeled reliable channel takes
    over (so recovery always converges). ``timeout``/``backoff``/
    ``jitter``/``max_retries`` only apply to ``drop``; the
    ``duplicate`` and ``rank_leave`` rules are switches for the
    sequence-number window and orphan-post cancellation."""

    kind: str
    max_retries: int = 3
    timeout: int = 2
    backoff: float = 2.0
    jitter: int = 1

    def __post_init__(self) -> None:
        if self.kind not in RECOVERABLE_KINDS:
            raise ValueError(
                f"unrecoverable fault kind {self.kind!r}; expected one "
                f"of {RECOVERABLE_KINDS}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.timeout < 1:
            raise ValueError("timeout must be >= 1 exchange")
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1.0")
        if self.jitter < 0:
            raise ValueError("jitter must be >= 0")

    def delay(self, attempt: int, rng: random.Random) -> int:
        """Modeled-tick wait before transmission attempt ``attempt``
        (0 = the first retransmit after the original drop)."""
        base = math.ceil(self.timeout * self.backoff ** attempt)
        if self.jitter:
            base += rng.randrange(self.jitter + 1)
        return max(1, int(base))

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, obj: Dict) -> "RecoveryRule":
        return cls(**{f.name: obj.get(f.name, f.default)
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """An ordered set of :class:`RecoveryRule`, at most one per kind."""

    rules: Tuple[RecoveryRule, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "rules", tuple(self.rules))
        seen = set()
        for r in self.rules:
            if r.kind in seen:
                raise ValueError(
                    f"policy has two rules for kind {r.kind!r}")
            seen.add(r.kind)

    def rule(self, kind: str) -> Optional[RecoveryRule]:
        for r in self.rules:
            if r.kind == kind:
                return r
        return None

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted(r.kind for r in self.rules))

    def to_dict(self) -> Dict:
        return {"format": POLICY_FORMAT, "version": POLICY_VERSION,
                "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, obj: Dict) -> "RecoveryPolicy":
        if obj.get("format", POLICY_FORMAT) != POLICY_FORMAT:
            raise ValueError(f"not a recovery policy: "
                             f"format={obj.get('format')!r}")
        return cls(rules=tuple(RecoveryRule.from_dict(r)
                               for r in obj.get("rules", ())))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "RecoveryPolicy":
        return cls.from_dict(json.loads(text))


def default_policy() -> RecoveryPolicy:
    """The canonical heal-everything policy the sweep's recovery axis
    and the recovery gate run: every recoverable kind, default knobs."""
    return RecoveryPolicy(rules=tuple(RecoveryRule(kind=k)
                                      for k in RECOVERABLE_KINDS))
