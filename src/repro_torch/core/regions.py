"""Caliper-analog region annotation API (paper §2.2, §4.1, Fig. 6).

    from repro_torch.core import regions

    with regions.annotate("post-send", category="api"):
        ...

Regions nest; the full path is recorded per event, which is what lets the
GraphFrame reconstruct the hierarchical context tree (paper Fig. 1).

Categories mirror ExaMPI's runtime-configurable profiling groups (§4.2):
profiling of each category can be switched on/off at runtime to bound
overhead and trace size. The default category set used by the framework:

    app         user/application level phases
    api         public framework entry points (the "MPI procedure calls")
    collective  communication primitives
    runtime     internal machinery (dispatch, queues, checkpoint I/O)
    data        input pipeline

A copy of ``repro.core.regions`` (the port imports nothing of the JAX
package), with :func:`annotate_torch` in place of ``annotate_jax``; while
a ``torch.profiler`` runs, each region is also a ``record_function`` span
(:func:`profiler_span`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Any, Dict, Iterator, Optional, Set

import torch

from .collector import Collector, global_collector
from .events import Event

DEFAULT_CATEGORIES = ("app", "api", "collective", "runtime", "data")


class ProfilingConfig:
    """Runtime profiling configuration (which categories are live, fencing)."""

    def __init__(self, categories: Optional[Set[str]] = None, fence: bool = False):
        # None => everything enabled
        self.categories: Optional[Set[str]] = categories
        # fence=True => regions wrapping device work synchronize the device
        # ("fenced" timing measures completion; unfenced measures dispatch).
        self.fence = fence

    def enabled(self, category: str) -> bool:
        return self.categories is None or category in self.categories


_config = ProfilingConfig()
_tls = threading.local()


_UNSET = object()


def configure(categories=_UNSET, fence=_UNSET) -> None:
    """Runtime re-configuration, like ExaMPI's profiling level toggles.
    ``categories=None`` enables everything; a set enables only those."""
    global _config
    cats = (_config.categories if categories is _UNSET
            else (set(categories) if categories is not None else None))
    fn = _config.fence if fence is _UNSET else bool(fence)
    _config = ProfilingConfig(categories=cats, fence=fn)


def config() -> ProfilingConfig:
    return _config


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = []
        _tls.stack = st
    return st


def current_path() -> tuple:
    return tuple(name for name, _cat in _stack())


def clock_ns() -> int:
    return time.perf_counter_ns()


@contextlib.contextmanager
def annotate(
    name: str,
    category: str = "app",
    collector: Optional[Collector] = None,
    **attrs: Any,
) -> Iterator[None]:
    """Annotate a region of interest (Caliper's ``cali_begin/end_region``)."""
    if not _config.enabled(category):
        yield
        return
    col = collector or global_collector()
    st = _stack()
    st.append((name, category))
    t0 = clock_ns()
    try:
        with profiler_span(name):
            yield
    finally:
        t1 = clock_ns()
        path = tuple(n for n, _c in st)
        st.pop()
        col.emit(
            Event(
                name=name,
                path=path,
                category=category,
                t_start=t0,
                t_end=t1,
                pid=col.pid,
                tid=col.normalized_tid(),
                attrs=dict(attrs) if attrs else None,
            )
        )


def profiler_span(name: str):
    """A ``record_function`` span named ``name`` while a ``torch.profiler``
    runs (so a device trace shows which region launched what, and what
    the host was in while the card idled), else a no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def profiled(name: Optional[str] = None, category: str = "app", **attrs: Any):
    """Decorator form of :func:`annotate`."""

    def deco(fn):
        region_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(region_name, category=category, **attrs):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def annotate_torch(
    name: str,
    category: str = "api",
    collector: Optional[Collector] = None,
    **attrs: Any,
) -> Iterator[Dict[str, Any]]:
    """Region for code that launches work on a CUDA card.

    If ``config().fence`` is set, the caller should place its outputs in the
    yielded dict under ``"out"``; the region then synchronizes the devices
    those tensors live on, so the recorded time is *completion* time, not
    launch time (the twin of ``annotate_jax``'s ``block_until_ready``).
    """
    box: Dict[str, Any] = {}
    with annotate(name, category=category, collector=collector, **attrs):
        yield box
        if _config.fence and "out" in box:
            from ..device import cuda_devices

            for dev in cuda_devices(box["out"]):
                torch.cuda.synchronize(dev)
