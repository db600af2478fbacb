"""Dry run of every arch x shape cell on the production mesh, on a fake
process group (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k [--multi-pod] [--device cpu] [--no-save]

The reference lowers and compiles each cell's step for the 16x16 (256
chips) and 2x16x16 (512) meshes from ``ShapeDtypeStruct`` inputs and reads
the compiled module. The port has no compiled module; its counterpart is
the step itself, run once under ``FakeTensorMode`` on a ``fake`` process
group of 256 or 512 ranks that this module initializes itself (a process
that already has a default group is refused): the production mesh is
built over it (``launch.mesh.make_production_mesh``), the inputs are fake
tensors of the specs' shapes (``launch.specs``) placed as DTensors by
the launchers' own ``place_model``, ``place_batch`` and ``place_caches``
(``R.tree_shardings``, ``R.batch_shardings``, ``R.cache_shardings``: the
reference's ``shardings_for``), and the step runs through the same code
as a real one.
Nothing is allocated and nothing is sent. A :class:`repro_torch.core.hlo.Recorder`
records rank 0's local ops and the ``_c10d_functional`` collectives that
DTensor and the models emit (the flash and scan kernels' wrappers take
their fake branch and add the kernels' work), from which the cell
reports, per device:

  * ``memory``: argument bytes (the local shards of the params, the AdamW
    state and the batch that the step reads, a kernel's fake launch
    included, as the reference's compiled step keeps only the arguments
    it uses: a vlm's decode reads no cross-attention ``wk``/``wv``, an
    xLSTM decode no position; the AdamW step counts as the reference's
    int32 scalar), output, alias (what the step updates in place: params
    and AdamW state in training, the caches in decode), temp (the peak of
    live storage bytes over the step less every argument and the new
    outputs) and ``per_device_total``, against ``HW["hbm_gb"]`` (80 GB);
  * ``walker``: FLOPs, bytes and collectives of ``hlo_cost.module_cost``;
    the bytes are every op's operands and results, an upper estimate of
    the card's HBM traffic (an operand read from L2, or a fused read,
    counts in full), not a figure to set beside the reference's: on the
    smoke cells of ``tests/test_torch_dryrun_jax.py`` they read 0.17–0.28
    of the reference walker's bytes (0.05 on jamba's train cell, whose
    jnp scan materializes its states), since the reference's walker
    counts XLA's HLO ops, each fusion's every operand and result;
    ``collectives_unscaled``: ``hlo.collective_stats``;
  * ``flash_launches_by_shape`` and ``scan_fake_launches`` (``fwd``,
    ``bwd``): the kernel calls the step made, through their fake branch;
  * ``roofline`` against ``launch.flops.model_flops``, and ``schedule``:
    the modeled schedule (``device_timeline.modeled_schedule``) and its
    ``serialization_report``;
  * ``t_lower_s``: the time the recording took.

These are model outputs for 256 or 512 H100s, not measurements. A
training cell runs one full step: forward, the full-remat recompute,
backward and AdamW. Left out: ``xla_cost_analysis`` (there is no XLA),
and ``--fused-accounting``: the hand-written kernels are always costed at
their boundary. Every family runs (xLSTM records plain ops only: no
kernel lies on its path); a cell that raises writes ``ok: false`` with
its error, as the reference records a failed cell. Results go to ``results/dryrun_torch/``.
``--device`` is ``cuda`` by default (a ``cuda`` mesh and fake ``cuda``
tensors); ``--device cpu`` runs anywhere. ``--mesh DxM``, ``--preset``,
``--layers``, ``--batch``, ``--seq`` and ``--d-expert`` dry-run a smaller
cell (the tests' and ``chip_smoke.py``'s).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs.archs import get_config
from ..configs.base import SHAPES, ShapeConfig, shapes_for
from ..core import cost, hlo, hlo_cost
from ..core.compat import mesh_from_devices
from ..core.device_timeline import modeled_schedule, serialization_report
from ..core.roofline import HW, Roofline
from ..models import model as M
from ..optim import adamw
from ..sharding import rules as R
from ..train.step import make_decode_step, make_prefill_step, make_train_step
from . import flops as F
from .mesh import make_production_mesh, production_mesh_shape
from .specs import input_specs
from .train import place_batch, place_caches, place_model

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


@contextlib.contextmanager
def fake_process_group(world: int):
    """A default ``fake`` process group of ``world`` ranks (this process is
    rank 0) for the block: collectives return at once, nothing is sent."""
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group: "
                           "run it in a process without a default group")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(sizes: Dict[str, int]) -> str:
    return "x".join(str(n) for n in sizes.values())


def step_and_args(cfg, shape: ShapeConfig, specs, mesh, rules, device,
                  microbatches: int = 1
                  ) -> Tuple[Any, List[torch.Tensor], List[torch.Tensor]]:
    """(step, arguments, donated) of one cell, to be called under
    ``FakeTensorMode``: ``step()`` runs the cell's step once on its placed
    inputs (the launchers' ``place_model``, ``place_batch``,
    ``place_caches``) and returns its outputs; ``arguments`` are the
    placed inputs; ``donated`` those the step updates in place (the
    reference's ``donate_argnums``)."""
    model = place_model(M.Model(cfg, device, trainable=shape.kind == "train"),
                        mesh, rules)
    params = dict(model.named_parameters())
    batch = place_batch({k: torch.empty(v.shape, dtype=v.dtype,
                                        device=device)
                         for k, v in specs["batch"].items()}, mesh, rules)
    if shape.kind == "train":
        opt = adamw.init_state(params)
        step_fn = make_train_step(cfg, adamw.AdamWConfig(),
                                  microbatches=microbatches)
        donated = [*params.values(), *opt["m"].values(), *opt["v"].values()]
        return (lambda: step_fn(model, opt, batch),
                donated + list(batch.values()), donated)

    B, S = shape.global_batch, shape.seq_len
    plen = len(cfg.pattern)

    def caches():
        # one layer's cache made and placed before the next: no rank holds
        # more than one layer's whole cache at a time
        return place_caches((M.alloc_cache(cfg, cfg.pattern[l % plen], B, S,
                                           device)
                             for l in range(cfg.n_layers)),
                            cfg, B, S, mesh, rules)

    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg)

        def step():
            cache = caches()
            return prefill(model, batch, cache), cache
        return step, list(params.values()) + list(batch.values()), []
    cache = caches()
    decode = make_decode_step(cfg)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    leaves = _leaves(cache)
    return (lambda: decode(model, cache, batch, pos),
            list(params.values()) + leaves + list(batch.values()) + [pos],
            leaves)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             save: bool = True, verbose: bool = True, microbatches: int = 1,
             tag: str = "", device: str = "cuda",
             mesh_shape: Optional[Tuple[int, ...]] = None,
             cfg=None, shape: Optional[ShapeConfig] = None) -> dict:
    """Dry-run one cell; returns the result dict (the reference's keys
    where a counterpart exists). ``cfg`` and ``shape`` override the named
    config and shape; ``mesh_shape`` the production mesh's shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..kernels.flash_attention.ops import flash_attention
    from ..kernels.mamba_scan.ops import selective_scan

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape, axes = production_mesh_shape(multi_pod=multi_pod)
    else:
        axes = ("pod", "data", "model")[-len(mesh_shape):]
    n_chips = int(np.prod(mesh_shape))
    dev = torch.device(device)
    with fake_process_group(n_chips):
        if mesh_shape == production_mesh_shape(multi_pod=multi_pod)[0]:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=dev.type)
        else:
            mesh = mesh_from_devices(np.arange(n_chips).reshape(mesh_shape),
                                     axes, dev.type)
        sizes = R.axis_sizes(mesh)
        rules = R.make_rules(mesh, shape)
        specs = input_specs(cfg, shape)
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, donated = step_and_args(
                cfg, shape, specs, mesh, rules, dev, microbatches)
            fake_before = dict(flash_attention.fake_launches_by_shape)
            scan_before = (selective_scan.fake_launches,
                           selective_scan.fake_bwd_launches)
            recorder = hlo.Recorder(track_memory=True)
            t0 = time.time()
            with R.sharding_context(mesh, rules), cost.tally(recorder):
                local_args = [_local(a) for a in args]
                rec = recorder.recording
                with recorder:
                    rec.hold(local_args)
                    rec.watch(local_args)
                    outputs = step()
            t_lower = time.time() - t0
            launches = {k: n - fake_before.get(k, 0) for k, n in
                        flash_attention.fake_launches_by_shape.items()
                        if n != fake_before.get(k, 0)}
            scan_launches = {
                "fwd": selective_scan.fake_launches - scan_before[0],
                "bwd": selective_scan.fake_bwd_launches - scan_before[1]}
            held = rec.storage_bytes(local_args)
            arg_bytes = rec.storage_bytes(rec.read_args(local_args))
            if shape.kind == "train":
                arg_bytes += 4                  # the AdamW step (int32)
            out_local = [_local(t) for t in _leaves(outputs)]
            alias = rec.storage_bytes([_local(t) for t in donated])
            new_out = rec.storage_bytes(out_local)
            peak = rec.peak_bytes
            del outputs, out_local, local_args, step, args, donated
    mc = hlo_cost.module_cost(rec)
    stats = hlo.collective_stats(rec)
    model_fl = F.model_flops(cfg, shape)
    roof = Roofline(flops=mc.flops, hbm_bytes=mc.bytes_accessed,
                    wire_bytes=mc.collective_wire_bytes, n_chips=n_chips,
                    model_flops=model_fl)
    ser = serialization_report(modeled_schedule(rec))
    ser_d = {
        "t_compute": ser.t_compute,
        "t_collective_total": ser.t_collective_total,
        "t_collective_exposed": ser.t_collective_exposed,
        "exposed_fraction": ser.exposed_fraction,
        "n_collectives": ser.n_collectives,
        "n_overlapped": ser.n_overlapped,
    }
    out_bytes = new_out + alias
    temp = max(0, peak - held - new_out)
    per_dev = arg_bytes + temp + out_bytes - alias
    result = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": mesh_name(sizes), "n_chips": n_chips,
        "device": dev.type,
        "ok": True,
        "microbatches": microbatches,
        "tag": tag,
        "t_lower_s": round(t_lower, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "per_device_total": per_dev,
            "fits_hbm": per_dev <= HW["hbm_gb"] * 1e9,
        },
        "walker": {
            "flops_per_device": mc.flops,
            "bytes_per_device": mc.bytes_accessed,
            "collective_operand_bytes": mc.collective_operand_bytes,
            "collective_wire_bytes": mc.collective_wire_bytes,
            "collective_count": mc.collective_count,
            "collectives_by_opcode": mc.collectives_by_opcode,
            "top_collectives": mc.top_collectives(12),
            "collectives_by_size": mc.collective_sizes,
            "trip_counts": mc.trip_counts[:32],
        },
        "collectives_unscaled": {
            "count": stats.count,
            "operand_bytes": stats.total_operand_bytes,
            "wire_bytes": stats.total_wire_bytes,
            "by_opcode": stats.by_opcode,
        },
        "flash_launches_by_shape": launches,
        "scan_fake_launches": scan_launches,
        "ops": len(rec),
        "model_flops": model_fl,
        "roofline": roof.to_dict(),
        "schedule": ser_d,
    }
    if verbose:
        print(f"== {cfg.name} x {shape.name} on {result['mesh']} "
              f"({n_chips} chips, fake, {dev.type}) ==")
        print(f"  recorded {len(rec)} ops in {t_lower:.1f}s")
        print(f"  memory/device: {per_dev / 1e9:.2f} GB (fits "
              f"{HW['hbm_gb']:.0f}GB: {result['memory']['fits_hbm']}) "
              f"{json.dumps(result['memory'])}")
        print(f"  walker flops/dev={mc.flops:.3e} bytes/dev="
              f"{mc.bytes_accessed:.3e} wire/dev="
              f"{mc.collective_wire_bytes:.3e}")
        print("  roofline: " + roof.summary())
        print(f"  {json.dumps(ser_d)}")
    if save:
        _save(result, cfg.name, shape.name, result["mesh"], tag)
    return result


def _save(result: dict, arch: str, shape_name: str, mesh: str,
          tag: str = "") -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    with open(os.path.join(RESULTS_DIR,
                           f"{arch}__{shape_name}__{mesh}{suffix}.json"),
              "w") as f:
        json.dump(result, f, indent=1)


def _parse_mesh(text: Optional[str]) -> Optional[Tuple[int, ...]]:
    return tuple(int(n) for n in text.split("x")) if text else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every cell in subprocesses (fault-isolated)")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="",
                    help="suffix for the result JSON (e.g. 'opt')")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): a cuda mesh; cpu runs anywhere")
    ap.add_argument("--mesh", default=None,
                    help="DxM (or PxDxM) in place of the production mesh")
    ap.add_argument("--preset", default="full", choices=["smoke", "full"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--d-expert", type=int, default=None,
                    help="cut the MoE expert width")
    args = ap.parse_args(argv)

    if args.all:
        import subprocess
        from ..configs.archs import ARCHS

        failures = []
        for arch in ARCHS:
            for shape_name in shapes_for(get_config(arch)):
                for mp in (False, True):
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape_name,
                           "--device", args.device]
                    if mp:
                        cmd.append("--multi-pod")
                    if args.no_save:
                        cmd.append("--no-save")
                    print(">>", " ".join(cmd), flush=True)
                    if subprocess.call(cmd) != 0:
                        failures.append((arch, shape_name, mp))
        print(f"dryrun --all finished; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    mesh_shape = _parse_mesh(args.mesh)
    mesh = (args.mesh or mesh_name(dict(zip(*reversed(
        production_mesh_shape(multi_pod=args.multi_pod))))))
    try:
        cfg = get_config(args.arch, args.preset)
        if args.layers:
            plen = len(cfg.pattern)
            cfg = dataclasses.replace(
                cfg, n_layers=max(plen, args.layers // plen * plen))
        if args.d_expert:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, d_expert=args.d_expert))
        shape = SHAPES[args.shape]
        if args.batch or args.seq:
            shape = dataclasses.replace(
                shape, global_batch=args.batch or shape.global_batch,
                seq_len=args.seq or shape.seq_len)
        result = run_cell(args.arch, args.shape, args.multi_pod,
                          save=not args.no_save,
                          microbatches=args.microbatches, tag=args.tag,
                          device=args.device, mesh_shape=mesh_shape,
                          cfg=cfg, shape=shape)
    except Exception:
        traceback.print_exc()
        result = {"arch": args.arch, "shape": args.shape, "mesh": mesh,
                  "ok": False, "error": traceback.format_exc()[-2000:]}
        if not args.no_save:
            _save(result, args.arch, args.shape, mesh, args.tag)
        print(json.dumps(result))
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
