"""The scenario gallery: ≥6 communication patterns spanning the space
the related-work profilers sweep (stencil halos, ring collectives,
transposes, sparse graphs, imbalance, storms, wildcard pipelines).

Each scenario is registered declaratively (:func:`repro_torch.workloads.base
.scenario`) and drives a :class:`repro_torch.match.Fabric` with traffic built
from :mod:`repro_torch.comm.patterns` — the same pair lists and tag
conventions the live comm layer dispatches — plus whatever adversarial
(but MPI-legal) post/arrival orderings the pattern calls for. ``expect``
declares which seeded defect each pattern is adversarial enough to
surface; the bench harness enforces those declarations and the README
gallery table is generated from them.

A copy of ``repro.workloads.scenarios``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

import random
from typing import Dict

from ..comm import patterns
from ..match import ANY_SOURCE, ANY_TAG, Fabric
from .base import scenario

Params = Dict[str, int]


@scenario(
    "halo3d",
    description="3-D stencil halo exchange: one face shift per (axis, "
                "direction) per step, the comm/halo.py pattern",
    stresses="steady bidirectional neighbor traffic; wildcard-consumed "
             "unexpected arrivals accumulate as UMQ garbage",
    defaults={"ranks": 8, "steps": 40, "face_bytes": 1 << 14},
    smoke={"steps": 24},
    expect=("leaky_umq", "shared"),
    fault_expect=("drop", "duplicate", "delay", "rank_leave",
                  "rank_join"),
    unexpected_every=2, wildcard_every=2,
)
def halo3d(fab: Fabric, rng: random.Random, p: Params) -> None:
    n = p["ranks"]
    with fab.fused():               # one batched dispatch per rank/drive
        for step in range(p["steps"]):
            fab.set_label(f"halo_step({step})")
            for ax, direction, perm, tag in patterns.halo_shifts(n):
                fab.ppermute(perm, nbytes=p["face_bytes"], tag=tag)
    fab.set_label(None)


@scenario(
    "ring_allreduce",
    description="ring all-reduce (reduce-scatter + all-gather phases), "
                "the comm/ring.py schedule",
    stresses="long dependent chains of ring-step messages; every rank "
             "both sends and receives each step",
    defaults={"ranks": 8, "rounds": 8, "nbytes": 1 << 18},
    smoke={"rounds": 5},
    expect=("leaky_umq", "shared"),
    fault_expect=("drop", "duplicate", "delay", "rank_leave",
                  "rank_join"),
    unexpected_every=2, wildcard_every=2,
)
def ring_allreduce(fab: Fabric, rng: random.Random, p: Params) -> None:
    for r in range(p["rounds"]):
        fab.set_label(f"all_reduce({r})")
        fab.all_reduce(p["ranks"], nbytes=p["nbytes"])
    fab.set_label(None)


@scenario(
    "alltoall_transpose",
    description="all-to-all matrix transpose with column-major delivery "
                "against row-major posts",
    stresses="every rank holds n-1 posted receives while arrivals land "
             "in reversed order — the adversarial case for a flat PRQ",
    defaults={"ranks": 28, "rounds": 4, "nbytes": 1 << 12},
    smoke={"rounds": 2},
    expect=("linear", "shared"),
    fault_expect=("drop", "duplicate", "delay", "rank_join"),
    unexpected_every=4, wildcard_every=0,
)
def alltoall_transpose(fab: Fabric, rng: random.Random,
                       p: Params) -> None:
    pairs = patterns.transpose_pairs(p["ranks"])
    deliver = patterns.reversed_pairs(pairs)
    for r in range(p["rounds"]):
        fab.phase(f"transpose({r})", n=p["ranks"])
        fab.exchange(pairs, tag=0, nbytes=p["nbytes"], deliver=deliver)


@scenario(
    "sparse_neighbors",
    description="sparse random neighbor exchange: each rank talks to a "
                "few seeded-random peers per round",
    stresses="irregular, asymmetric queue shapes — no rank sees the "
             "same traffic twice",
    defaults={"ranks": 16, "degree": 3, "rounds": 10, "nbytes": 1 << 12},
    smoke={"rounds": 6},
    expect=("shared",),
    fault_expect=("drop", "duplicate", "delay", "rank_join"),
)
def sparse_neighbors(fab: Fabric, rng: random.Random, p: Params) -> None:
    rounds = patterns.random_neighbor_rounds(p["ranks"], p["degree"],
                                             p["rounds"], rng)
    with fab.fused():               # one batched dispatch per rank/drive
        for r, pairs in enumerate(rounds):
            fab.phase(f"sparse({r})", n=p["ranks"])
            fab.exchange(pairs, tag=r, nbytes=p["nbytes"])


@scenario(
    "master_worker",
    description="master-worker imbalance: every worker floods rank 0, "
                "which consumes via wildcard receives and carries a "
                "deep reversed-drain receive backlog",
    stresses="one hot rank: UMQ storm from racing workers plus a deep "
             "PRQ drained in reverse",
    defaults={"ranks": 8, "per_worker": 8, "backlog": 64, "rounds": 6},
    smoke={"rounds": 3},
    expect=("linear", "leaky_umq", "shared"),
    unexpected_every=0, wildcard_every=0,
)
def master_worker(fab: Fabric, rng: random.Random, p: Params) -> None:
    n, m, backlog = p["ranks"], p["per_worker"], p["backlog"]
    master = fab.engine(0)
    workers = [w for w, _ in patterns.hot_rank_pairs(n, hot=0,
                                                     per_worker=m)]
    wildcards = [ANY_SOURCE] * len(workers)
    for r in range(p["rounds"]):
        fab.phase(f"master_worker({r})", n=n)
        # workers race the master's posts: results arrive unexpected
        master.arrive_batch(workers, tag=200 + (r % m), nbytes=1 << 10)
        # master consumes whoever-finished-first via ANY_SOURCE
        master.post_recv_batch(wildcards, tag=200 + (r % m))
        # imbalance backlog: a pile of specific receives, drained in
        # reverse post order (legal, adversarial for a flat PRQ)
        master.post_recv_tags(1, range(1_000, 1_000 + backlog))
        master.arrive_tags(1, reversed(range(1_000, 1_000 + backlog)),
                           nbytes=1 << 8)


@scenario(
    "unexpected_storm",
    description="unexpected-message storm: senders race every post, "
                "bursts land before any receive exists",
    stresses="the UMQ: every arrival parks unexpected; wildcard "
             "consumption turns the burst into permanent garbage under "
             "the leaky defect",
    defaults={"ranks": 8, "burst": 24, "rounds": 4},
    smoke={"rounds": 3},
    expect=("leaky_umq", "shared"),
    fault_expect=("rank_join",),
    unexpected_every=1, wildcard_every=2,
)
def unexpected_storm(fab: Fabric, rng: random.Random, p: Params) -> None:
    n, burst = p["ranks"], p["burst"]
    for r in range(p["rounds"]):
        fab.phase(f"storm({r})", n=n, burst=burst)
        # the fabric's own mix: every ppermute message arrives before
        # its receive is posted (unexpected_every=1)
        fab.ppermute(patterns.ring_perm(n), nbytes=1 << 10, tag=r)
        # plus a direct burst per rank, consumed by ANY_TAG wildcards
        wildcards = [ANY_SOURCE] * burst
        for rank in range(n):
            eng = fab.engine(rank)
            eng.arrive_tags((rank + 1) % n, range(300, 300 + burst),
                            nbytes=1 << 9)
            eng.post_recv_batch(wildcards, tag=ANY_TAG)


@scenario(
    "wildcard_pipeline",
    description="wildcard-heavy pipeline: each stage posts specific-tag "
                "receives plus trailing ANY_TAG wildcards, producer "
                "delivers in descending-tag order",
    stresses="PRQ traversal past a wall of specifics to reach wildcard "
             "entries — worst case for a linear posted-receive queue",
    defaults={"stages": 5, "batch": 48, "wildcards": 12, "rounds": 3},
    smoke={"rounds": 2},
    expect=("linear", "shared"),
    unexpected_every=0, wildcard_every=0,
)
def wildcard_pipeline(fab: Fabric, rng: random.Random, p: Params) -> None:
    batch, wild = p["batch"], p["wildcards"]
    for r in range(p["rounds"]):
        fab.phase(f"pipeline({r})", stages=p["stages"])
        for stage in range(1, p["stages"]):
            consumer = fab.engine(stage)
            producer = stage - 1
            consumer.post_recv_tags(producer, range(batch))
            consumer.post_recv_batch([producer] * wild, tag=ANY_TAG)
            consumer.arrive_tags(producer,
                                 reversed(range(batch + wild)),
                                 nbytes=1 << 11)


# -- production-shaped scenarios (the repro_torch.faults pack) -------------------
#
# Five patterns mirroring the proxy-app communication signatures the
# Caliper/Benchpark study profiles (AMG2023 shrinking-participation
# halos, Kripke wavefront sweeps) plus three serving/elastic shapes.
# Each declares ``fault_expect``: the injected fault kinds whose
# canonical plan its traffic makes detectable — the sweep's fault axis
# (scenario_sweep.py --faults) enforces the declarations.


@scenario(
    "amg_coarsen",
    description="algebraic-multigrid V-cycle: ring halos over a "
                "participant set that halves per level, then a binomial "
                "tree fold to rank 0 and broadcast back",
    stresses="shrinking participation — high ranks idle at coarse "
             "levels while low ranks keep matching; tree fan-in "
             "concentrates arrivals toward the root",
    defaults={"ranks": 16, "cycles": 3, "steps": 2,
              "halo_bytes": 1 << 13},
    smoke={"cycles": 2},
    expect=("shared",),
    fault_expect=("drop", "duplicate", "delay", "rank_leave"),
)
def amg_coarsen(fab: Fabric, rng: random.Random, p: Params) -> None:
    n = p["ranks"]
    with fab.fused():               # one batched dispatch per rank/drive
        for c in range(p["cycles"]):
            active, level = n, 0
            while active >= 2:
                fab.phase(f"amg_halo(c={c},l={level})", n=active)
                for s in range(p["steps"]):
                    tag = (level << 4) | s
                    fab.exchange(patterns.ring_perm(active), tag=tag,
                                 nbytes=p["halo_bytes"] >> level)
                    fab.exchange(patterns.ring_perm(active, -1), tag=tag,
                                 nbytes=p["halo_bytes"] >> level)
                active >>= 1
                level += 1
            # coarse solve: binomial fold to rank 0, broadcast back down
            fab.phase(f"amg_tree(c={c})", n=n)
            levels = patterns.tree_pairs(n)
            for i, lv in enumerate(levels):
                fab.exchange(lv, tag=900 + i, nbytes=p["halo_bytes"])
            for i, lv in enumerate(reversed(levels)):
                fab.exchange(patterns.swap_pairs(lv), tag=950 + i,
                             nbytes=p["halo_bytes"])


@scenario(
    "kripke_sweep",
    description="Kripke-style wavefront sweep over a 2-D rank grid: "
                "one exchange per diagonal, sweep corner rotating "
                "through all four quadrants",
    stresses="dependency-ordered delivery — each diagonal's sends gate "
             "the next; corner rotation reverses every flow direction",
    defaults={"gx": 4, "gy": 4, "sweeps": 10, "nbytes": 1 << 12},
    smoke={"sweeps": 8},
    expect=("shared",),
    fault_expect=("delay", "rank_leave"),
)
def kripke_sweep(fab: Fabric, rng: random.Random, p: Params) -> None:
    gx, gy = p["gx"], p["gy"]
    with fab.fused():               # one batched dispatch per rank/drive
        for s in range(p["sweeps"]):
            fab.phase(f"sweep({s})", corner=s % 4)
            diagonals = patterns.kripke_diagonals(gx, gy, s % 4)
            for d, pairs in enumerate(diagonals):
                if pairs:
                    fab.exchange(pairs, tag=d, nbytes=p["nbytes"])


@scenario(
    "power_law_burst",
    description="bursty fan-in with heavy-tailed sizes: each round one "
                "hot rank absorbs a power-law-sized batch from every "
                "peer, all of it ahead of the receives",
    stresses="deep parked burst at a rotating hot rank: every arrival "
             "is unexpected, every receive digs the parked set",
    defaults={"ranks": 16, "rounds": 10, "base_bytes": 1 << 9},
    smoke={"rounds": 8},
    expect=("shared",),
    fault_expect=("drop", "duplicate", "reorder", "delay"),
    unexpected_every=1, wildcard_every=0,
)
def power_law_burst(fab: Fabric, rng: random.Random, p: Params) -> None:
    n = p["ranks"]
    rounds = patterns.power_law_rounds(n, p["rounds"], p["base_bytes"],
                                       rng)
    with fab.fused():               # one batched dispatch per rank/drive
        for r, (pairs, nb) in enumerate(rounds):
            fab.phase(f"burst({r})", hot=r % n, msgs=len(pairs))
            fab.exchange(pairs, tag=r, nbytes=nb)


@scenario(
    "request_reply",
    description="serving-shaped RPC traffic: every round all clients "
                "fan their request quota into the round's hot shard "
                "server; replies fan back with one straggling client's "
                "batch delivered last",
    stresses="hot-shard fan-in parks the whole round's requests at one "
             "server; the reply deliver= permutation holds a straggling "
             "client's batch behind every other reply",
    defaults={"clients": 24, "servers": 4, "quota": 3, "rounds": 6,
              "reply_bytes": 1 << 10},
    smoke={"rounds": 4},
    expect=("shared",),
    fault_expect=("drop", "duplicate", "reorder", "delay"),
    unexpected_every=1, wildcard_every=0,
)
def request_reply(fab: Fabric, rng: random.Random, p: Params) -> None:
    nc, ns, q = p["clients"], p["servers"], p["quota"]
    with fab.fused():               # one batched dispatch per rank/drive
        for r in range(p["rounds"]):
            shard = nc + r % ns       # this round's hot shard server
            fab.phase(f"rpc({r})", shard=shard)
            for w in range(q):        # one request wave per quota slot
                tag = 2 * (r * q + w)
                # request fan-in: every client's wave-w request lands at
                # the hot shard (ranks nc..nc+ns-1 rotate the role)
                req = patterns.fan_in_pairs(nc, shard)
                fab.exchange(req, tag=tag, nbytes=64)
                # replies fan back; the straggling client's reply lands
                # after all others (a legal delivery-order permutation)
                rep = patterns.swap_pairs(req)
                laggard = (r + w) % nc
                fab.exchange(rep, tag=tag + 1, nbytes=p["reply_bytes"],
                             deliver=patterns.laggard_last(rep, laggard))


@scenario(
    "elastic_ranks",
    description="elastic membership: the world shrinks and regrows "
                "across epochs, each epoch rebuilding its mesh "
                "(checkpoint.elastic.viable_meshes) and re-syncing the "
                "survivors with a recursive-doubling butterfly",
    stresses="membership churn — ranks idle whole epochs, rejoin, and "
             "every epoch ends in an all-ranks butterfly barrier",
    defaults={"ranks": 12, "epochs": 8, "nbytes": 1 << 12},
    smoke={"epochs": 4},
    expect=("shared",),
    fault_expect=("delay", "rank_leave"),
)
def elastic_ranks(fab: Fabric, rng: random.Random, p: Params) -> None:
    def viable_meshes(n, prefer_model=16):
        # (data, model) factorizations, best-first: model parallelism as
        # close to the preferred width as divisibility allows
        return [(n // m, m)
                for m in range(min(prefer_model, n), 0, -1)
                if n % m == 0]
    n = p["ranks"]
    with fab.fused():               # one batched dispatch per rank/drive
        for e in range(p["epochs"]):
            # world size churns: full, minus one, minus two, full, ...
            w = n - (e % 3)
            data, model = viable_meshes(w, prefer_model=4)[0]
            fab.phase(f"epoch({e})", world=w, data=data, model=model)
            if model > 1:
                # model-parallel ring within each surviving mesh group
                for g in range(data):
                    fab.exchange(patterns.shifted_ring(g * model, model),
                                 tag=e << 4, nbytes=p["nbytes"])
            # post-churn re-sync: butterfly allreduce across the world
            for s, stage in enumerate(patterns.butterfly_pairs(w)):
                fab.exchange(stage, tag=(e << 4) | (s + 1),
                             nbytes=p["nbytes"] // 2)
