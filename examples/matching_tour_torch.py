"""Message-matching profiling (paper method 2), end to end (the port of
``examples/matching_tour.py``).

    PYTHONPATH=src:. python examples/matching_tour_torch.py [--device cpu]

1. Shows the two-queue matching engine's semantics: envelope matching
   with MPI wildcards, per-envelope FIFO, expected vs unexpected paths.
2. Routes the real comm layer (ring collectives under shard_map on an
   8-rank single-controller mesh, every rank's block on the CUDA card
   unless ``--device cpu`` is given) through a matching Fabric and
   snapshots the counters into Event records — rendered as a GraphFrame
   tree and a chrome trace, the same viewers as method 1.
3. Seeds the paper-style defects (linear PRQ search, leaky UMQ) and shows
   ``analyze_all`` flagging exactly the defective engines.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def wildcard_demo():
    from repro_torch.core.counters import CounterRegistry
    from repro_torch.match import ANY_SOURCE, ANY_TAG, MatchEngine

    print("== matching semantics ==")
    eng = MatchEngine(mode="binned", registry=CounterRegistry())
    r_wild = eng.post_recv(src=ANY_SOURCE, tag=ANY_TAG)   # posted first
    r_spec = eng.post_recv(src=3, tag=7)
    eng.arrive(src=3, tag=7)       # matches the *earlier posted* wildcard
    print(f"first arrival -> wildcard recv completed: {r_wild.completed}, "
          f"specific still pending: {not r_spec.completed}")
    eng.arrive(src=3, tag=7)       # now the specific recv
    print(f"second arrival -> specific recv completed: {r_spec.completed}")
    eng.arrive(src=5, tag=9)       # nothing posted: unexpected path
    r_late = eng.post_recv(src=5, tag=9)
    print(f"late recv pulled the unexpected message: {r_late.completed}\n")


def comm_layer_tour(device):
    import torch

    from repro_torch.comm import collectives
    from repro_torch.comm.ring import ring_all_gather
    from repro_torch.core import timeline
    from repro_torch.core.compat import make_mesh, shard_map
    from repro_torch.core.counters import CounterRegistry
    from repro_torch.core.graphframe import GraphFrame
    from repro_torch.device import fence
    from repro_torch.match import Fabric

    n = 8          # ranks are blocks of one mesh: no device count to honor
    print(f"== comm layer through the matching engine ({n} ranks on "
          f"{device}) ==")
    reg = CounterRegistry()
    collectives.configure_matching(Fabric(mode="binned", registry=reg))
    try:
        mesh = make_mesh((n,), ("r",), device=device)
        x = mesh.shard(torch.arange(n * 4 * 2, dtype=torch.float32
                                    ).reshape(n * 4, 2))
        out = shard_map(lambda s: ring_all_gather(s, "r"), mesh=mesh)(x)
        fence(out)
        y = mesh.shard(torch.ones((n, 4), dtype=torch.float32))
        out2 = shard_map(lambda s: collectives.psum(s, "r"), mesh=mesh)(y)
        fence(out2)
    finally:
        collectives.configure_matching(None)

    from repro_torch.core.counters import counter_stats

    events = reg.snapshot_events()
    print("counter stats from the ring_all_gather + psum dispatches:")
    for name, st in sorted(counter_stats(events).items()):
        line = f"  {name:30s} count={st.count:<6d} total={st.total:<10.0f}"
        if st.kind == "histogram":
            line += f" mean={st.mean:.2f} max={st.vmax:.0f}"
        print(line)
    print("counter tree (GraphFrame over snapshot events):")
    gf = GraphFrame.from_events(events)
    print(gf.tree(metric="count", fmt="{:.0f}"))
    path = os.path.join(tempfile.gettempdir(), "matching_counters_torch.json")
    timeline.save_trace(timeline.to_chrome_trace(events), path)
    print(f"counter snapshot trace: {path} (chrome://tracing)\n")


def defect_tour():
    from repro_torch.core import analyses
    from repro_torch.core.counters import CounterRegistry
    from repro_torch.match import Fabric

    print("== seeded defects vs the detectors ==")
    for mode in ("binned", "linear", "leaky_umq"):
        reg = CounterRegistry()
        fab = Fabric(mode=mode, registry=reg)
        for r in range(30):
            fab.all_reduce(16, nbytes=1 << 20)
            eng = fab.engine(0)
            for t in range(512):
                eng.post_recv(src=1, tag=1000 + t)
            for t in reversed(range(512)):
                eng.arrive(src=1, tag=1000 + t)
        findings = [f for f in analyses.analyze_all(reg.snapshot_events())
                    if f.kind in ("long_traversal", "umq_flood")]
        label = "fixed" if mode == "binned" else "defect"
        print(f"mode={mode:10s} ({label}): "
              f"{analyses.report(findings, limit=2)}")
    print()


def main(argv=None):
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    device = resolve_device(ap.parse_args(argv).device)
    wildcard_demo()
    comm_layer_tour(device)
    defect_tour()
    print("tour complete — see benchmarks/matching_sweep.py for the "
          "queue-depth figures and README.md for the method mapping")


if __name__ == "__main__":
    main()
