"""Timeline profiling (paper method 2), end to end (the port of
``examples/timeline_tour.py``).

    PYTHONPATH=src:. python examples/timeline_tour_torch.py [--device cpu]

1. Runs a matmul workload through the progress engine with one shared
   queue and captures a two-thread trace (user thread + progress thread),
   on the CUDA card unless ``--device cpu`` is given.
2. Runs the automated timeline analyses of §4.1 — the contention detector
   finds the BlockingProgress-lock overlap as in the paper's Fig 8.
3. Re-runs with the second (incoming) queue and shows the contention gone
   (Fig 9), with the Isend latency under each.
4. Models a device timeline from a recorded step, where the reference
   models it from compiled HLO: a tensor-parallel layer (x split over
   ``"model"`` by columns, the weight by rows, the partial products summed
   over ``"model"``) runs as DTensors on a 4-rank fake process group,
   under ``FakeTensorMode`` (nothing is allocated or sent), and its
   recorded ops give the modeled schedule and its serialization report.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_engine(mode: str, device, n_requests: int = 48):
    import torch

    from repro_torch.comm.progress import ProgressEngine
    from repro_torch.core.collector import global_collector, reset_global_collector
    from repro_torch.device import fence

    def work(x):
        return (x @ x).sum()

    x = torch.ones((1024, 1024), dtype=torch.float32, device=device)
    fence(work(x))
    reset_global_collector()
    eng = ProgressEngine(mode)
    reqs = []
    # staggered submission so the user thread keeps enqueueing while the
    # progress thread is mid-processing — the realistic steady state
    for i in range(n_requests):
        reqs.append(eng.submit(work, x))
        if i % 4 == 3:
            time.sleep(0.002)
    for r in reqs:
        r.wait()
    eng.shutdown()
    return global_collector().drain()


def modeled_tp_layer(device_type: str) -> None:
    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.core import device_timeline as DT
    from repro_torch.core import hlo
    from repro_torch.core.compat import mesh_from_devices
    from repro_torch.launch.dryrun import fake_process_group

    with fake_process_group(4):
        mesh = mesh_from_devices(np.arange(4), ("model",), device_type)
        with FakeTensorMode():
            x = distribute_tensor(torch.empty((128, 256), dtype=torch.bfloat16,
                                              device=device_type),
                                  mesh, [Shard(1)])
            w = distribute_tensor(torch.empty((256, 512), dtype=torch.bfloat16,
                                              device=device_type),
                                  mesh, [Shard(0)])

            def tp_layer():
                return (x @ w).redistribute(mesh, [Replicate()])

            _, rec = hlo.record(tp_layer)
    print(rec.as_text())
    print(hlo.collective_stats(rec).summary())
    segs = DT.modeled_schedule(rec)
    print(DT.serialization_report(segs).summary())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args()

    from repro_torch.core import analyses, timeline
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    tmp = tempfile.gettempdir()
    threads = {0: "user thread", 1: "progress thread"}

    print("== one shared queue (pre-fix ExaMPI) ==")
    ev_old = run_engine("shared", device)
    findings = analyses.contention(ev_old, name_filter="BlockingProgress")
    print(analyses.report(findings, limit=5))
    isend_old = [e.duration / 1e3 for e in ev_old if e.name == "MPI_Isend"]
    print(f"MPI_Isend mean {sum(isend_old)/len(isend_old):.1f} us "
          f"max {max(isend_old):.1f} us over {len(isend_old)} calls")
    shared = os.path.join(tmp, "timeline_shared_queue_torch.json")
    timeline.save_trace(timeline.to_chrome_trace(ev_old, thread_names=threads),
                        shared)

    print("\n== second incoming queue (the fix) ==")
    ev_new = run_engine("incoming", device)
    findings_new = analyses.contention(ev_new, name_filter="BlockingProgress")
    print(analyses.report(findings_new, limit=5))
    isend_new = [e.duration / 1e3 for e in ev_new if e.name == "MPI_Isend"]
    print(f"MPI_Isend mean {sum(isend_new)/len(isend_new):.1f} us "
          f"max {max(isend_new):.1f} us")
    incoming = os.path.join(tmp, "timeline_incoming_queue_torch.json")
    timeline.save_trace(timeline.to_chrome_trace(ev_new, thread_names=threads),
                        incoming)
    print(f"\ntraces: {shared}, {incoming} (chrome://tracing)")

    print("\n== modeled device timeline from a recorded step "
          "(fake process group) ==")
    modeled_tp_layer(device.type)
    print("\ntour complete")


if __name__ == "__main__":
    main()
