"""How the multi-rank tests run their ranks on the CPU, and what each rank
runs: :func:`run_ranks` spawns one process a rank, joined in a default
process group through a ``FileStore`` (gloo, no fixed port); the rank
functions below are importable by name from a spawned interpreter, and
free of JAX so that a rank starts quickly.

    results = run_ranks(fn, 4, arg, store_dir=tmp)   # fn(rank, world, arg)
"""
import dataclasses
import os
import time
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, fn: Callable, world: int, args: tuple, store: str,
           out_dir: str, backend: str, threads: int) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args: Any, store_dir: str,
              backend: str = "gloo", timeout: float = 300.0,
              threads: int = 1) -> List[Any]:
    """``fn(rank, world, *args)`` on ``world`` spawned processes, each with
    ``threads`` intra-op threads; returns what each rank returned, by rank.
    Raises if a rank raises, or ``TimeoutError`` (after killing every rank)
    when they are not done within ``timeout`` seconds."""
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.time_ns()}")
    out_dir = store + ".out"
    os.makedirs(out_dir)
    ctx = mp.start_processes(_entry, args=(fn, world, args, store, out_dir,
                                           backend, threads),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{world} ranks of {fn.__name__} took more "
                               f"than {timeout} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]




def train_runs(rank, world, runs):
    """Each run of ``runs`` ((name, config changes, argv)) through
    ``launch.train.main`` in f32, with the first step's gradients
    gathered (``full_tensor``) as the optimizer receives them. Returns
    {name: (losses, grads)} on rank 0 and None elsewhere. Works with no
    process group too (one process)."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import unshard

    get_config, apply_updates = train.get_config, adamw.apply_updates
    out = {}
    try:
        for name, changes, argv in runs:
            grads = {}

            def recording(params, g, state, cfg):
                if not grads:
                    grads.update({n: unshard(t).detach().clone()
                                  for n, t in g.items()})
                return apply_updates(params, g, state, cfg)

            train.get_config = lambda arch, preset: dataclasses.replace(
                get_config(arch, preset), dtype="float32", **changes)
            adamw.apply_updates = recording
            losses, _stats = train.main(argv)
            out[name] = (losses, grads)
    finally:
        train.get_config, adamw.apply_updates = get_config, apply_updates
    return out if rank == 0 else None


def compressed_psum_rank(rank, world, grads_by_rank, errors_by_rank):
    """``compressed_psum`` of this rank's gradients and errors (numpy
    dicts) over the world: (reduced, new errors) as numpy."""
    from repro_torch.optim.compress import compressed_psum

    g = {k: torch.from_numpy(v) for k, v in grads_by_rank[rank].items()}
    e = {k: torch.from_numpy(v) for k, v in errors_by_rank[rank].items()}
    red, err = compressed_psum(g, e)
    return ({k: v.numpy() for k, v in red.items()},
            {k: v.numpy() for k, v in err.items()})
