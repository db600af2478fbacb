# The paper's primary contribution: communication-layer profiling
# infrastructure — region annotation (Caliper analog), hierarchical
# GraphFrames (Hatchet analog), comparison-based profiling (method 1),
# chrome-trace timelines + automated analyses (method 2), and the H100
# adaptation: roofline terms from counted work and measured device
# timelines (``cost``, ``device_timeline``, imported by name).
#
# The public names of ``repro.core``, with ``annotate_torch`` in place of
# ``annotate_jax``. ``hlo`` and ``hlo_cost`` read a recorded step (the
# port's counterpart of XLA's compiled text; the dry run records it).
#
# ``regions``, ``compat``, ``hlo`` and ``hlo_cost`` import torch, and the
# host packages (``telemetry``, ``faults``, ``workloads``, ``corpus``)
# import ``core.counters`` without it. So those modules and the names
# that come from ``regions`` load at first use (PEP 562 ``__getattr__``);
# every other module here imports no torch and loads with the package.
from importlib import import_module

from . import analyses, comparison, counters, graphframe, timeline
from .collector import Collector, global_collector, reset_global_collector
from .counters import (CounterLane, CounterRegistry, CounterStat,
                       counter_stats, global_registry, lane_events,
                       merge_lane_stats, reduce_lanes,
                       reset_global_registry)
from .comparison import (ComparisonResult, ProfileReport, ReportRow,
                         compare, compare_frames, profile_runs)
from .events import Event
from .graphframe import GraphFrame
from .roofline import HW, Roofline

_LAZY = ("regions", "compat", "hlo", "hlo_cost")
_FROM_REGIONS = ("annotate", "annotate_torch", "configure", "profiled")

__all__ = [
    "analyses", "comparison", "compat", "counters", "graphframe", "hlo",
    "hlo_cost", "regions", "timeline", "Collector", "global_collector",
    "reset_global_collector", "CounterLane", "CounterRegistry", "CounterStat",
    "counter_stats", "global_registry", "lane_events", "merge_lane_stats",
    "reduce_lanes", "reset_global_registry",
    "ComparisonResult", "ProfileReport", "ReportRow", "compare",
    "compare_frames", "profile_runs", "Event",
    "GraphFrame", "annotate", "annotate_torch", "configure", "profiled",
    "HW", "Roofline",
]


def __getattr__(name):
    if name in _LAZY:
        return import_module(f".{name}", __name__)
    if name in _FROM_REGIONS:
        return getattr(import_module(".regions", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
