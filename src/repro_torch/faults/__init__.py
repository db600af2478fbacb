"""Deterministic fault injection and recovery (``repro_torch.faults``).

Declarative, seeded fault plans (:mod:`~repro_torch.faults.plan`) applied to
scenario runs through the matching fabric's sanctioned rewrite seams
(:mod:`~repro_torch.faults.inject`): dropped / duplicated / reordered /
delayed deliveries plus ranks leaving and joining mid-run — the
transport-level failure modes the detectors in
:mod:`repro_torch.core.analyses` (``orphan_posts``, ``duplicate_match``,
``reorder_inflation``, ``straggler_rank``) are built to flag.

On top of injection sit the self-healing and predictive layers:
seeded :class:`~repro_torch.faults.recovery.RecoveryPolicy` healing applied
through the same seams (retransmits, duplicate suppression, orphan-
post cancellation — detectors ``recovered_drop`` /
``suppressed_duplicate`` / ``retry_storm``), and fault-aware what-if
replay (:mod:`~repro_torch.faults.whatif`) that predicts a faulted run's
counter lanes and findings from a *healthy* recorded trace.

A copy of ``repro.faults``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from .inject import FaultyFabric, build_faulty, finish_faults
from .plan import (FaultPlan, FaultSpec, JOINER_RANK, KINDS,
                   composite_kinds, composite_names, composite_plan,
                   composite_plans, default_plan, plans, single)
from .recovery import (RECOVERABLE_KINDS, RecoveryPolicy, RecoveryRule,
                       default_policy)
from .whatif import WhatIfResult, whatif

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "FaultyFabric",
    "JOINER_RANK",
    "KINDS",
    "RECOVERABLE_KINDS",
    "RecoveryPolicy",
    "RecoveryRule",
    "WhatIfResult",
    "build_faulty",
    "composite_kinds",
    "composite_names",
    "composite_plan",
    "composite_plans",
    "default_plan",
    "default_policy",
    "finish_faults",
    "plans",
    "single",
    "whatif",
]
