#!/usr/bin/env python3
"""The benchmark of the port (``src/repro_torch``) on an NVIDIA H100.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix; the mix's
``kind`` picks the driver (:mod:`chipbench.serve` or
:mod:`chipbench.train`). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared with its limit (also the last lines of
standard error).

It exits non-zero and prints no result without a CUDA card (or with
fewer cards than the cell asks for), and when a module of JAX, or the
JAX package ``repro``, is loaded once the window has closed.
``--control`` also reads the control (the reference in fp8) over the
same sample, ``--fault half_batch`` trains the program on half of each
batch (a fault the check must catch); ``--smoke`` runs the cell at its configuration's and mix's
smoke sizes on the CPU, for the tests.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the port, and this package, from the checkout
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# every build and kernel cache of the program inside the checkout, at a
# fixed path, so that only a checkout's first run builds
_CACHE = ROOT / "build" / "chipbench"
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", str(_CACHE / "cuda"))
os.environ.setdefault("USE_FLAX", "0")

# top-level module names that must not be loaded: JAX, and the JAX
# package the port was made from (``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a driver needs of the run: the clock's start, the device,
    and the device's synchronisation, memory peak and profiler."""

    def __init__(self, smoke: bool):
        import torch

        self.torch = torch
        self.smoke = smoke
        self.t_start = T_START
        self.device = torch.device("cpu" if smoke else "cuda")
        if not smoke:
            torch.cuda.reset_peak_memory_stats()

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(self.torch.cuda.max_memory_allocated())
        return 0

    def empty_cache(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def span(self, name: str):
        """A ``record_function`` span while the profiler runs."""
        if self.torch._C._autograd._profiler_enabled():
            return self.torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def profile(self, fn):
        """(fn(), the Kineto trace of its run) on the card; on the CPU
        (smoke runs) the trace is None."""
        if self.device.type != "cuda":
            return fn(), None
        from chipbench.frozen.device_timeline import profile

        return profile(fn)


def metric_reader(name: str):
    path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def device_info(ctx: Context, out: dict, chips: int) -> dict:
    torch = ctx.torch
    info = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if ctx.device.type == "cuda" else "cpu"),
            "count": chips,
            "memory_peak_bytes": out["memory_peak_bytes"]}
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    args = ap.parse_args(argv)

    from chipbench import cells
    from chipbench.check import within

    c = cells.cell(args.workload)
    import torch

    if not args.smoke and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < c["chips"]):
        print(f"chipbench: {args.workload} needs {c['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(args.smoke)
    kind = c["traffic_file"]["kind"]
    driver = importlib.import_module(f"chipbench.{kind}")
    out = driver.run(c, args, ctx)

    bench = c["bench"]
    limits = cells.sized(c["limits_file"], args.smoke)
    # the cell compares the readings its limits name
    checks = {k: out["readings"][k] for k in limits}
    correct = within(checks, limits)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    device = device_info(ctx, out, c["chips"])
    metrics = {}
    if args.trace:
        from chipbench.tracing import breakdown, device_times

        record = dict(out["record"], trace=out["trace"])
        for m in bench["per_layer"]:
            if not _applies(m, args.workload):
                continue
            value = metric_reader(m["name"])(record)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if out["trace"] is not None:
            device.update(device_times(out["trace"]))
            result["breakdown"] = breakdown(out["trace"])
    else:
        for m in bench["end_to_end"]:
            if not _applies(m, args.workload):
                continue
            value = (out["setup_s"] if m["name"] == "setup_s"
                     else out["end_to_end"].get(m["name"]))
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    result["readings"] = out["readings"]
    if out.get("control") is not None:
        result["control"] = out["control"]
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}

    found = forbidden_modules()
    if found:
        print(f"chipbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
