"""Communication-backend registry — the 'MPI implementations' under study.

  xla_auto          GSPMD decides every collective (vendor black box; the
                    Spectrum-MPI analog: tuned, closed, opaque).
  explicit_serial   shard_map + hand-written collectives, one-queue
                    schedules (the original ExaMPI: strong progress
                    *intended* but producer/consumer serialized).
  explicit_overlap  same code with double-buffered schedules (ExaMPI after
                    the paper's second-queue fix).
  explicit_serial_oversub
                    explicit_serial plus a deliberate host-scheduling
                    defect (eager per-op fencing), reproducing §3's
                    core-oversubscription finding: *compute-only* regions
                    slow down too, which is the signature the comparison
                    tree exposes (ratios < 1 on non-MPI regions).

Port of ``repro.comm.backends``. On one card "GSPMD decides" reads "the
library decides": the vendor analog rolls the global field with
``torch.roll`` (:mod:`repro_torch.comm.halo`), and the explicit backends
run the port's ``shard_map`` counterpart (:mod:`repro_torch.comm.mesh`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..device import cuda_devices


@dataclasses.dataclass(frozen=True)
class CommBackend:
    name: str
    kind: str                      # "auto" | "explicit"
    schedule: str                  # "auto" | "serial" | "overlap"
    fence_every_op: bool = False   # host defect knob (core-scheduling analog)
    description: str = ""


BACKENDS: Dict[str, CommBackend] = {
    "xla_auto": CommBackend(
        "xla_auto", "auto", "auto",
        description="GSPMD-chosen collectives (vendor baseline)"),
    "explicit_serial": CommBackend(
        "explicit_serial", "explicit", "serial",
        description="shard_map, one-queue schedules (pre-fix ExaMPI)"),
    "explicit_overlap": CommBackend(
        "explicit_overlap", "explicit", "overlap",
        description="shard_map, double-buffered schedules (second queue)"),
    "explicit_serial_oversub": CommBackend(
        "explicit_serial_oversub", "explicit", "serial", fence_every_op=True,
        description="serial + host fencing defect (core-scheduling analog)"),
}


def get_backend(name: str) -> CommBackend:
    return BACKENDS[name]


def maybe_fence(backend: CommBackend, *arrays):
    """The deliberate defect: eagerly synchronize after every dispatched
    op, so host scheduling (not the wire) throttles even compute-only
    regions — the paper's core-oversubscription signature. The fence is
    ``torch.cuda.synchronize`` when a tensor lies on a card; operations on
    the CPU complete as they are issued."""
    if backend.fence_every_op:
        for dev in cuda_devices(arrays):
            torch.cuda.synchronize(dev)
    return arrays
