"""The COMB-analog halo app under one comm backend (the port's
counterpart of ``benchmarks/halo_child.py``'s body).

    PYTHONPATH=src python -m repro_torch.launch.halo \
        --backend explicit_overlap --box 128 --steps 4 --runs 5

Runs on the CUDA card unless ``--device cpu`` is given; with no card and
no ``--device cpu`` it raises. The ranks are blocks of one
single-controller mesh (:mod:`repro_torch.comm.mesh`): 8 ranks are a
2 x 2 x 2 mesh of ``--box``³ f32 blocks, one global field on one device.
The field is ``np.random.default_rng(seed).standard_normal``, as the
reference's.

One warm-up run, fed through a matching fabric (the binned engine; the
reference's fabric fires while its segments are traced, once), then
``--runs`` timed runs without it, each from the same field. Prints one
JSON object: per-run GraphFrames, wall times, the warm-up's checksum,
the fabric's counters, and with ``--trace-out`` writes the last run's
chrome trace there. :func:`main` returns the same payload as a dict;
:func:`run` also returns the last run's output field (stacked blocks).

``--emit-device-timeline`` (on the card only; the counterpart of
``halo_child.py --emit-hlo-stats``) profiles one more run with
``torch.profiler`` (the progress engine's stream is the collective
lane) and adds ``device_timeline`` (its serialization report,
its collectives and the card's report on that run) and ``hlo_stats``
(the reference's keys ``count``, ``operand_bytes``, ``wire_bytes``,
``by_opcode``, read from the run's collective regions).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..comm import collectives
from ..comm.backends import BACKENDS, get_backend
from ..comm.halo import HaloProgram
from ..comm.mesh import Mesh
from ..comm.progress import ProgressEngine
from ..core import device_timeline, regions, timeline
from ..core.collector import reset_global_collector
from ..core.cost import collective_stats
from ..core.counters import CounterRegistry
from ..core.graphframe import GraphFrame
from ..device import resolve_device
from ..match import Fabric

MESH_DIMS = {8: (2, 2, 2), 4: (2, 2, 1), 2: (2, 1, 1), 1: (1, 1, 1)}


def _counters(stats) -> Dict[str, Dict[str, float]]:
    """Counter name -> its count, total, min and max (the fabric's
    registry, drained)."""
    return {name: {"count": s.count, "total": s.total, "vmin": s.vmin,
                   "vmax": s.vmax}
            for name, s in sorted(stats.items())}


def run(backend: str = "explicit_overlap", ranks: int = 8, box: int = 32,
        steps: int = 4, runs: int = 5, device: str = "cuda", seed: int = 0,
        trace_out: Optional[str] = None, emit_device_timeline: bool = False
        ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Run the halo app; return (payload, output of the last run as the
    mesh's stacked blocks)."""
    dev = resolve_device(device)
    if emit_device_timeline and dev.type != "cuda":
        raise ValueError("--emit-device-timeline reads the card's clock: it "
                         "needs --device cuda")
    be = get_backend(backend)
    dims = MESH_DIMS[ranks]
    mesh = Mesh(dims, ("x", "y", "z"), device=dev)
    global_shape = tuple(d * box for d in dims)
    u0 = mesh.shard(torch.from_numpy(
        np.random.default_rng(seed).standard_normal(global_shape)
    ).to(torch.float32))

    engine = None
    if be.kind == "auto":
        prog = HaloProgram(mesh, explicit=False)
    else:
        prog = HaloProgram(mesh, explicit=True)
        engine = ProgressEngine(
            "shared" if be.schedule == "serial" else "incoming")

    def run_once(u):
        return prog.run(u, steps=steps, engine=engine,
                        fence_every_op=be.fence_every_op)

    registry = CounterRegistry()
    try:
        collectives.configure_matching(
            Fabric(mode="binned", registry=registry))
        out = run_once(u0)                   # warm-up, fed to the fabric
        collectives.configure_matching(None)
        checksum = float(out.double().abs().sum())

        frames, walls, trace = [], [], None
        for r in range(runs):
            col = reset_global_collector()
            t0 = time.perf_counter()
            with regions.annotate("add_vars", category="api"):
                u = u0 * 1.0
            out = run_once(u)
            walls.append(time.perf_counter() - t0)
            events = col.drain()
            frames.append(GraphFrame.from_events(events).to_dict())
            if trace_out and r == runs - 1:
                trace = timeline.to_chrome_trace(events)
        timed = (_device_timeline(run_once, u0, mesh)
                 if emit_device_timeline else {})
    finally:
        collectives.configure_matching(None)
        if engine is not None:
            engine.shutdown()
    if trace is not None:
        timeline.save_trace(trace, trace_out)
    payload = {
        "backend": backend,
        "devices": ranks,
        "mesh": list(dims),
        "box": box,
        "steps": steps,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "frames": frames,
        "walls": walls,
        "checksum": checksum,
        "counters": _counters(registry.drain()),
        "trace": trace_out if trace is not None else None,
        "device_timeline": timed.get("device_timeline"),
        "hlo_stats": timed.get("hlo_stats"),
    }
    return payload, out


def _device_timeline(run_once, u0: torch.Tensor, mesh: Mesh
                     ) -> Dict[str, Any]:
    """One more run under the profiler: the payload's ``device_timeline``
    and ``hlo_stats``."""
    col = reset_global_collector()
    t0 = time.perf_counter()
    _, trace = device_timeline.profile(run_once, u0 * 1.0)
    wall = time.perf_counter() - t0
    stats = collective_stats(col.drain(), mesh.shape)
    report = device_timeline.serialization_report(
        device_timeline.extract_schedule(trace))
    return {"hlo_stats": stats, "device_timeline": {
        "serialization": dict(dataclasses.asdict(report),
                              exposed_fraction=report.exposed_fraction,
                              summary=report.summary()),
        "collectives": stats,
        "device": device_timeline.device_report(trace),
        "engine_streams": [str(s) for s in
                           device_timeline.side_streams(trace)],
        "profiled_wall_s": wall,
    }}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="explicit_overlap",
                    choices=sorted(BACKENDS))
    ap.add_argument("--devices", type=int, default=8,
                    choices=sorted(MESH_DIMS),
                    help="ranks of the mesh (8: 2 x 2 x 2)")
    ap.add_argument("--box", type=int, default=32, help="local box edge")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None,
                    help="write the last run's chrome trace here")
    ap.add_argument("--emit-device-timeline", action="store_true",
                    help="profile one more run on the card: serialization "
                         "report, collective stats, device report")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    payload, _ = run(args.backend, args.devices, args.box, args.steps,
                     args.runs, args.device, args.seed, args.trace_out,
                     args.emit_device_timeline)
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
