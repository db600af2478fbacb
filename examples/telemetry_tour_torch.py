"""Live telemetry, end to end: watch a defect surface *mid-run* (the port
of ``examples/telemetry_tour.py``).

    PYTHONPATH=src:. python examples/telemetry_tour_torch.py

The tour drives the host packages' matching fabric alone: nothing of it
runs on a card, so it takes no ``--device``.

Everything else in this repo is post-hoc — run, then read the profile.
This tour runs the ``unexpected_storm`` scenario with the leaky-UMQ
defect seeded, with a :class:`TelemetryBridge` polling the run's counter
registry from its own daemon thread and an HTTP/SSE endpoint serving the
stream. A client thread polls ``/findings`` over plain HTTP the whole
time — and sees the ``umq_flood`` detector fire while the workload is
still executing, not in the post-mortem:

1. delta frames stream to an in-process ring + a JSONL file while the
   storm drives the fabric (throttled, so the run spans many polls);
2. the ``/findings`` poller reports the flood the moment the cumulative
   UMQ stats cross the detector thresholds;
3. at the end, the bridge's cumulative lanes reproduce exactly the
   queue statistics a bridged-off run computes — streaming changed
   *when* the deltas were folded, never what they sum to.
"""
import json
import os
import random
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from repro_torch.telemetry import (JsonlSink, TelemetryBridge,
                                 TelemetryServer, read_jsonl)
    from repro_torch.workloads import get
    from repro_torch.workloads.bench import build_fabric

    sc = get("unexpected_storm")
    p = sc.params("smoke")

    bridge = TelemetryBridge(period_s=0.01, session="telemetry_tour")
    sink_path = os.path.join(os.path.dirname(__file__), "..", "results",
                             "telemetry_tour_torch.jsonl")
    os.makedirs(os.path.dirname(sink_path), exist_ok=True)
    bridge.subscribe(JsonlSink(sink_path))
    server = TelemetryServer(bridge).start()
    bridge.start()
    print(f"telemetry up: {server.url}  (endpoints: /metrics /stream "
          f"/findings)\n")

    fab = build_fabric(sc, "leaky_umq")
    bridge.watch(fab.reg, name="storm")

    done = threading.Event()
    seen_at = {}

    def watch_findings():
        # a plain-HTTP client, like a dashboard would be
        while not done.is_set():
            with urllib.request.urlopen(server.url + "/findings",
                                        timeout=2) as r:
                for f in json.loads(r.read()):
                    key = (f["kind"], f.get("pid"))
                    if key not in seen_at:
                        seen_at[key] = time.perf_counter()
                        state = ("MID-RUN" if not done.is_set()
                                 else "post-run")
                        print(f"  [{state}] /findings: [{f['kind']}] "
                              f"pid {f.get('pid')} — {f['message']}")
            time.sleep(0.02)

    watcher = threading.Thread(target=watch_findings, daemon=True)
    watcher.start()

    print(f"driving unexpected_storm (leaky_umq, params {p}) ...")
    rng = random.Random(0)
    t0 = time.perf_counter()
    # throttle the drive so the storm spans many poll periods — a real
    # workload has compute between messages; sleep stands in for it
    for round_ in range(6):
        sc.drive(fab, rng, {**p, "rounds": 1})
        time.sleep(0.05)
    wall = time.perf_counter() - t0
    done.set()
    watcher.join()
    bridge.stop()

    floods = [k for k in seen_at if k[0] == "umq_flood"]
    live = [k for k in floods if seen_at[k] < t0 + wall]
    print(f"\nworkload ran {wall * 1e3:.0f} ms; umq_flood seen on "
          f"{len(floods)} rank(s), {len(live)} of them before the run "
          "finished")

    lanes = bridge.unwatch("storm")
    total = sum(per["match.umq.length"].count for per in lanes.values())
    print(f"cumulative lanes: {len(lanes)} ranks, "
          f"{total} UMQ-length samples, "
          f"{bridge.deltas_total} deltas over {bridge.polls} polls "
          f"(drop-free: {fab.reg.drain_stats()['pending']} pending)")

    server.stop()
    bridge.close()
    frames = read_jsonl(sink_path)
    kinds = {}
    for f in frames:
        kinds[f["t"]] = kinds.get(f["t"], 0) + 1
    print(f"JSONL sink: {len(frames)} frames {kinds} -> {sink_path}")


if __name__ == "__main__":
    main()
