"""The port's fault injection, recovery and what-if replay
(``repro_torch.faults``) against the JAX package's (``repro.faults``).

For each fault kind's canonical plan (and the canonical composites), the
faulted run writes the reference's trace byte for byte and reaches the
reference's detector verdicts, healed or not; fault plans and recovery
policies serialize to the reference's JSON and round-trip; invalid specs
are refused with the reference's messages; and ``whatif`` over the
committed healthy traces gives the reference's predictions, with and
without recovery.
"""
import hashlib
import os

import pytest

from repro import faults as jax_faults
from repro import workloads as jax_workloads
from repro.corpus import signature as jax_signature
from repro_torch import faults, workloads
from repro_torch.corpus import FAULT_CELLS, finding_kinds, signature
from repro_torch.faults import (FaultPlan, FaultSpec, RecoveryPolicy,
                                RecoveryRule)
from repro_torch.faults.whatif import WhatIfError
from repro_torch.trace import replay

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS_ROOT = os.path.join(HERE, "corpus")

# one cell for each canonical plan (delay shows only live, so it is not
# in the corpus), and the canonical composites
LIVE_CELLS = tuple(FAULT_CELLS) + (("request_reply", "delay"),
                                   ("halo3d", "drop+delay"),
                                   ("ring_allreduce", "duplicate+reorder"))


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _verdicts(run):
    return (run.finding_kinds, run.defect_kinds, run.fault_kinds, run.fault,
            run.n_ops, run.row()["depth_mean"], run.row()["umq_max"])


def test_every_kind_has_a_live_cell():
    kinds = {k for _, cell in LIVE_CELLS for k in cell.split("+")}
    assert kinds == set(faults.KINDS) == set(jax_faults.KINDS)


@pytest.mark.parametrize("healed", [False, True], ids=["faulted", "healed"])
@pytest.mark.parametrize("sc,kind", LIVE_CELLS,
                         ids=[f"{s}-{k}" for s, k in LIVE_CELLS])
def test_faulted_run_is_the_reference(tmp_path, sc, kind, healed):
    port_policy = faults.default_policy() if healed else None
    ref_policy = jax_faults.default_policy() if healed else None
    got_path = str(tmp_path / "port.jsonl")
    want_path = str(tmp_path / "ref.jsonl")
    got = workloads.run_scenario(sc, engine_mode="fifo", size="smoke",
                                 seed=0, fault=kind, recovery=port_policy,
                                 trace_path=got_path, wall_clock=False)
    want = jax_workloads.run_scenario(sc, engine_mode="fifo", size="smoke",
                                      seed=0, fault=kind,
                                      recovery=ref_policy,
                                      trace_path=want_path, wall_clock=False)
    assert _sha256(got_path) == _sha256(want_path)
    assert _verdicts(got) == _verdicts(want)
    if not healed:
        member_detectors = {workloads.FAULT_DETECTOR[k]
                            for k in kind.split("+")}
        assert member_detectors & set(got.fault_kinds)


@pytest.mark.parametrize("name", list(faults.KINDS) + ["drop+delay",
                                                       "duplicate+reorder"])
def test_plan_json_is_the_reference(name):
    if "+" in name:
        got = faults.composite_plan(name, seed=7)
        want = jax_faults.composite_plan(name, seed=7)
    else:
        got = faults.default_plan(name, seed=7)
        want = jax_faults.default_plan(name, seed=7)
    text = got.to_json()
    assert text == want.to_json()
    back = FaultPlan.from_json(text)
    assert back == got and back.to_json() == text
    assert got.to_dict()["format"] == "repro.faults.plan"


def test_policy_json_is_the_reference():
    got, want = faults.default_policy(), jax_faults.default_policy()
    text = got.to_json()
    assert text == want.to_json()
    back = RecoveryPolicy.from_json(text)
    assert back == got and back.to_json() == text
    assert got.to_dict()["format"] == "repro.faults.recovery"
    assert faults.RECOVERABLE_KINDS == jax_faults.RECOVERABLE_KINDS


@pytest.mark.parametrize("cls,bad", [
    ("FaultSpec", dict(kind="nope")),
    ("FaultSpec", dict(kind="drop", rate=1.5)),
    ("FaultSpec", dict(kind="reorder", k=0)),
    ("FaultSpec", dict(kind="delay")),
    ("FaultSpec", dict(kind="rank_join", rank=1, every=0)),
    ("RecoveryRule", dict(kind="reorder")),
    ("RecoveryRule", dict(kind="drop", backoff=0.5)),
], ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v.values())))
def test_invalid_spec_is_refused_as_the_reference(cls, bad):
    with pytest.raises(ValueError) as got:
        {"FaultSpec": FaultSpec, "RecoveryRule": RecoveryRule}[cls](**bad)
    with pytest.raises(ValueError) as want:
        getattr(jax_faults, cls)(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("healed", [False, True], ids=["faulted", "healed"])
@pytest.mark.parametrize("sc,kind", FAULT_CELLS,
                         ids=[f"{s}-{k}" for s, k in FAULT_CELLS])
def test_whatif_is_the_reference(sc, kind, healed):
    healthy = os.path.join(CORPUS_ROOT, f"{sc}__fifo.jsonl")
    got = faults.whatif(healthy, faults.default_plan(kind, seed=0),
                        policy=faults.default_policy() if healed else None)
    want = jax_faults.whatif(
        healthy, jax_faults.default_plan(kind, seed=0),
        policy=jax_faults.default_policy() if healed else None)
    assert got.finding_kinds == want.finding_kinds
    assert signature(got.replay) == jax_signature(want.replay)
    assert got.stats == want.stats
    assert got.n_ops == want.n_ops > 0
    if healed and kind == "drop":
        assert "recovered_drop" in got.finding_kinds
        assert "orphan_posts" not in got.finding_kinds


def test_whatif_predicts_the_committed_faulted_trace():
    healthy = os.path.join(CORPUS_ROOT, "halo3d__fifo.jsonl")
    faulted = os.path.join(CORPUS_ROOT, "halo3d__fifo__fault_drop.jsonl")
    wr = faults.whatif(healthy, faults.default_plan("drop", seed=0))
    live = replay(faulted, check_matches=False)
    assert wr.finding_kinds == finding_kinds(live)
    assert signature(wr.replay) == signature(live)


def test_whatif_wrong_unexpected_every_raises():
    healthy = os.path.join(CORPUS_ROOT, "halo3d__fifo.jsonl")
    with pytest.raises(WhatIfError):
        faults.whatif(healthy, faults.default_plan("drop"),
                      unexpected_every=3)
