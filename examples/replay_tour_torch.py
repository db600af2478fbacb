"""Record once, replay everywhere (the trace subsystem), end to end (the
port of ``examples/replay_tour.py``).

    PYTHONPATH=src:. python examples/replay_tour_torch.py [--device cpu]

1. Records a *live* comm-layer run — ring all-gather + psum under
   shard_map on an 8-rank single-controller mesh, every rank's block on
   the CUDA card unless ``--device cpu`` is given — through
   :func:`repro_torch.trace.record_collectives`:
   every collective the program dispatches is decomposed into p2p
   messages, matched, and appended to a JSONL trace.
2. Replays that single trace offline under all three engine modes (no
   JAX, no re-execution) and shows the live detectors running on the
   replayed counter events.
3. Diffs the what-if replays against the healthy baseline with the trace
   differ — the regression primitive: the seeded-defect engines are
   flagged, the healthy engine diffs clean.
4. Feeds the replayed match latency into the roofline / modeled device
   timeline (method-2 counters on the modeled timeline) and exports the
   replay as a chrome trace with one lane per rank.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TRACE = os.path.join(tempfile.gettempdir(), "replay_tour_torch_trace.jsonl")


def record_live_run(device):
    import torch

    from repro_torch.comm import collectives
    from repro_torch.comm.ring import ring_all_gather
    from repro_torch.core.compat import make_mesh, shard_map
    from repro_torch.core.counters import CounterRegistry
    from repro_torch.device import fence
    from repro_torch.trace import record_collectives

    n = 8          # ranks are blocks of one mesh: no device count to honor
    print(f"== 1. record a live comm-layer run ({n} ranks on {device}) ==")
    reg = CounterRegistry()
    with record_collectives(TRACE, mode="binned", registry=reg,
                            meta={"example": "replay_tour"}) as fab:
        mesh = make_mesh((n,), ("r",), device=device)
        x = mesh.shard(torch.arange(n * 4 * 2, dtype=torch.float32
                                    ).reshape(n * 4, 2))
        out = shard_map(lambda s: ring_all_gather(s, "r"), mesh=mesh)(x)
        fence(out)
        y = mesh.shard(torch.ones((n, 4), dtype=torch.float32))
        out2 = shard_map(lambda s: collectives.psum(s, "r"), mesh=mesh)(y)
        fence(out2)
        # a many-outstanding-receives burst (the paper's Fig. 10 load) so
        # the linear-PRQ what-if replay below has depth to regress on
        fab.phase("burst", rank=0, outstanding=128)
        eng = fab.engine(0)
        for t in range(128):
            eng.post_recv(src=1, tag=10_000 + t)
        for t in reversed(range(128)):
            eng.arrive(src=1, tag=10_000 + t)

    from repro_torch.trace import read_trace
    header, records = read_trace(TRACE)
    phases = [r for r in records if r["t"] == "phase"]
    ops = [r for r in records if r["t"] in ("post", "arr")]
    print(f"recorded {len(ops)} engine ops across {len(phases)} phases "
          f"(schema v{header['schema']}): {TRACE}")
    print("phase labels:", sorted({p["label"] for p in phases}), "\n")
    return header, records


def replay_everywhere(source):
    from repro_torch.core import analyses
    from repro_torch.trace import replay

    print("== 2. replay offline under every engine mode ==")
    replays = {}
    for mode in ("fifo", "linear", "leaky_umq"):
        res = replay(source, mode=mode)
        replays[mode] = res
        tot = res.totals()
        depth = tot.get("match.prq.traversal_depth")
        flags = sorted({f.kind for f in analyses.analyze_all(res.events)
                        if f.kind in ("long_traversal", "umq_flood")})
        print(f"mode={mode:10s}: ops replayed={len(res.matches)}, "
              f"divergences={len(res.divergences)}, "
              f"depth_mean={depth.mean if depth else 0:.2f}, "
              f"detector flags={flags}")
    print("(divergences=0 everywhere: the defects change cost, never "
          "matching — what-if replay is sound)\n")
    return replays


def diff_replays(replays):
    from repro_torch.trace import diff

    print("== 3. trace differ vs the healthy baseline ==")
    base = replays["fifo"]
    for mode in ("linear", "leaky_umq"):
        d = diff(base, replays[mode])
        # the live-run workload is small, so use gentle thresholds here;
        # benchmarks/replay_sweep.py gates the full-size defaults
        flags = d.flags(depth_factor=2.0, depth_mean=2.0,
                        min_depth_samples=8, umq_factor=2.0, umq_len=4.0)
        print(f"fifo -> {mode}:")
        for f in flags[:3]:
            print("   " + str(f))
        if not flags:
            print("   (clean)")
    print()


def model_tie_in(replays):
    from repro_torch.core import timeline
    from repro_torch.core.device_timeline import (Segment, overlay_match_lane,
                                            to_events)
    from repro_torch.core.roofline import Roofline, match_seconds

    print("== 4. measured match latency on the modeled timeline ==")
    tot = replays["linear"].totals()
    match_s = match_seconds(tot)
    roof = Roofline(flops=1e12, hbm_bytes=1e9, wire_bytes=4e8, n_chips=8,
                    match_s=match_s)
    print(f"roofline with measured match term: {roof.summary()}")

    # a toy modeled schedule: compute / collective / compute
    segments = [Segment("matmul", "compute", 2e-3),
                Segment("all-gather", "collective", 1e-3),
                Segment("matmul", "compute", 2e-3)]
    events = to_events(segments)
    lane = overlay_match_lane(events, tot)
    print(f"match lane: {len(lane)} event(s), "
          f"{sum(e.duration for e in lane) / 1e6:.3f} ms modeled on tid 2")

    replay_trace = os.path.join(tempfile.gettempdir(),
                                "replay_tour_torch_replay.json")
    per_rank = replays["fifo"].events
    timeline.save_trace(timeline.to_chrome_trace(per_rank), replay_trace)
    print(f"replayed counter timeline (one lane per rank): {replay_trace} "
          f"(chrome://tracing)\n")


def main(argv=None):
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    source = record_live_run(resolve_device(ap.parse_args(argv).device))
    replays = replay_everywhere(source)
    diff_replays(replays)
    model_tie_in(replays)
    print("tour complete — benchmarks/replay_sweep.py is the acceptance "
          "gate; README.md documents the record-once/replay-everywhere "
          "workflow")


if __name__ == "__main__":
    main()
