"""How the multi-rank tests run their ranks on the CPU, and what each rank
runs: :func:`run_ranks` spawns one process a rank, joined in a default
process group through a ``FileStore`` (gloo, no fixed port); the rank
functions below are importable by name from a spawned interpreter, and
free of JAX so that a rank starts quickly.

    results = run_ranks(fn, 4, arg, store_dir=tmp)   # fn(rank, world, arg)
"""
import contextlib
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




def set_gates(model, gate):
    """Every cross-attention gate of ``model`` to ``gate`` (None leaves
    them at their init of 0, where tanh(0) = 0 zeroes the sublayer);
    returns the model."""
    if gate is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith(".gate"):
                    p.fill_(gate)
    return model


def split_gate(changes):
    """(the ``"cross_gate"`` of config ``changes``, the other changes)."""
    changes = dict(changes)
    return changes.pop("cross_gate", None), changes


def train_runs(rank, world, runs):
    """Each run of ``runs`` ((name, config changes, argv)) through
    ``launch.train.main`` in f32, with the first step's gradients
    gathered (``full_tensor``) as the optimizer receives them; a
    ``"cross_gate"`` among the changes sets every cross-attention gate of
    the seed-0 weights. Returns {name: (losses, grads)} on rank 0 and None
    elsewhere. Works with no process group too (one process)."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import unshard

    get_config, apply_updates = train.get_config, adamw.apply_updates
    model_cls = train.Model
    out = {}
    try:
        for name, changes, argv in runs:
            gate, changes = split_gate(changes)

            class Gated(model_cls):
                def init_weights(self, seed):
                    return set_gates(super().init_weights(seed), gate)

            train.Model = Gated
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
        train.Model = model_cls
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


def serve_runs(rank, world, runs):
    """Greedy serving of each run of ``runs`` ((name, arch, config changes,
    --model-parallel, batch, prompt length, new tokens)) in f32 from seed-0
    weights and a seeded prompt: prefill, then decode. A ``frames`` model
    takes seeded frames (the prompt's, then one a decode step) where the
    others take tokens; a vlm model's prefill takes seeded encoder
    embeddings beside its prompt (a ``"cross_gate"`` among the changes
    sets its gates). With a process group the weights and caches are
    DTensors on a (data, model) mesh, prefill under the prefill rules and
    decode under the decode rules; without one the model runs plain.
    Returns {name: (tokens (B, gen), [the logits of each step] as numpy,
    the placements of the first cross-attention cache's keys as text, or
    None)} on rank 0, None elsewhere."""
    import numpy as np

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import place_batch, place_caches, place_model
    from repro_torch.models.model import Model
    from repro_torch.sharding import rules as R
    from repro_torch.train.step import make_decode_step, make_prefill_step

    cpu = torch.device("cpu")
    out = {}
    for name, arch, changes, mp, B, P, G in runs:
        gate, changes = split_gate(changes)
        cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                                  **changes)
        model = set_gates(Model(cfg, cpu).init_weights(0), gate)
        caches = model.alloc_cache(B, P + G)
        rng = np.random.default_rng(1)
        frames = cfg.input_mode == "frames"
        if frames:
            prompt = torch.from_numpy(rng.standard_normal(
                (B, P + G, cfg.d_model)).astype(np.float32))
        else:
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, P)).astype(np.int32))
        extra = {}
        if cfg.encoder_len:
            extra["encoder_embeddings"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder_len, cfg.d_model)).astype(np.float32))
        ctx = {}
        if world > 1:
            mesh = make_mesh_for(world, mp)
            pre = R.make_rules(mesh, ShapeConfig("p", P, B, "prefill"))
            dec = R.make_rules(mesh, ShapeConfig("d", P + G, B, "decode"))
            place_model(model, mesh, pre)
            caches = place_caches(caches, cfg, B, P + G, mesh, dec)
            ctx = {"prefill": (mesh, pre), "decode": (mesh, dec)}

        def under(kind):
            return (R.sharding_context(*ctx[kind]) if ctx
                    else contextlib.nullcontext())

        def batch_of(inputs, kind, **more):
            b = {"frames" if frames else "tokens": inputs, **more}
            return place_batch(b, *ctx[kind]) if ctx else b

        with torch.no_grad():
            with under("prefill"):
                logits = make_prefill_step(cfg)(
                    model, batch_of(prompt[:, :P], "prefill", **extra),
                    caches)
            step = make_decode_step(cfg)
            all_logits = [R.unshard(logits).numpy()]
            tok = R.unshard(logits).argmax(-1).to(torch.int32)   # (B, ncb)
            toks = [tok]
            for i in range(G - 1):
                nxt_in = prompt[:, P + i:P + i + 1] if frames else tok[:, :1]
                with under("decode"):
                    logits, nxt = step(model, caches,
                                       batch_of(nxt_in, "decode"), P + i)
                all_logits.append(R.unshard(logits).numpy())
                tok = R.unshard(nxt)
                toks.append(tok)
        cross = next((c["cross_kv"]["k"] for c in caches if "cross_kv" in c),
                     None)
        placed = getattr(cross, "placements", None)
        out[name] = (torch.cat(toks, 1).numpy(), all_logits,
                     None if placed is None else str(placed))
    return out if rank == 0 else None


def counted_train_steps(rank, world, runs):
    """One f32 train step of each run ((name, config, --model-parallel,
    batch, seq[, cross-attention gate])) on a (data, model) mesh from
    seed-0 weights and the
    launcher's first batch (int32 tokens and labels, as the dry run's
    specs), counted by ``count_cost`` and by ``CommDebugMode``. Returns {name: {"flops", "by_shape",
    "scan": {"fwd", "bwd": the scan kernels' calls}, "collectives":
    {opcode: {count, operand_bytes}}, "comm_counts": {opcode: count}}} on
    rank 0."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core import cost
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import place_batch, place_model
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    from repro_torch.train.step import make_train_step

    names = (("all_gather", "all-gather"), ("reduce_scatter",
             "reduce-scatter"), ("all_reduce", "all-reduce"),
             ("allreduce", "all-reduce"), ("allgather", "all-gather"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("broadcast", "collective-broadcast"))
    out = {}
    for name, cfg, mp, B, T, *gate in runs:
        mesh = make_mesh_for(world, mp)
        rules = R.make_rules(mesh)
        model = place_model(set_gates(Model(
            cfg, torch.device("cpu"), trainable=True).init_weights(0),
            *gate or (None,)), mesh, rules)
        batch = {k: torch.from_numpy(v.astype(
            "int32" if v.dtype.kind in "iu" else "float32")) for k, v in
                 SyntheticTokens(cfg, DataConfig(batch=B, seq_len=T))
                 .batch_at(0).items()}
        batch = place_batch(batch, mesh, rules)
        opt = adamw.init_state(dict(model.named_parameters()))
        step = make_train_step(cfg, adamw.AdamWConfig())
        with R.sharding_context(mesh, rules):
            with cost.count_cost() as c, \
                    CommDebugMode() as comm:
                step(model, opt, batch)
        counts = {}
        for op, n in comm.get_comm_counts().items():
            key = next(v for k, v in names if k in str(op))
            counts[key] = counts.get(key, 0) + n
        out[name] = {"flops": c.flops, "by_shape": c.by_shape,
                     "scan": {k: c.kernels.get(n, {}).get("launches", 0)
                              for k, n in (("fwd", "selective_scan"),
                                           ("bwd", "selective_scan_bwd"))},
                     "collectives": {k: {"count": d["count"],
                                         "operand_bytes": d["operand_bytes"]}
                                     for k, d in c.collectives.items()},
                     "comm_counts": counts}
    return out if rank == 0 else None


def one_rank_bits(rank, world, runs):
    """One f32 train step of each run ({name: (arch, expert width or
    None[, cross-attention gate])}; B 4, T 64, seed-0 weights, the
    launcher's first batch) plain,
    then on DTensors over a (1,1) mesh. Returns {name: {"loss": (plain,
    sharded), "differ": [the parameters whose gradients differ in any
    bit], "tokens_moved": whether the MoE took the path where the tokens
    move}}."""
    from repro_torch.configs.archs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    from repro_torch.train.step import make_train_step

    mesh = make_mesh_for(world, 1)
    rules = R.make_rules(mesh)
    calls = []
    tokens = moe._sharded_tokens

    def counted(*args, **kwargs):
        calls.append(1)
        return tokens(*args, **kwargs)

    out = {}
    moe._sharded_tokens = counted
    try:
        for name, (arch, d_expert, *gate) in runs.items():
            cfg = dataclasses.replace(get_config(arch, "smoke"),
                                      dtype="float32")
            if d_expert is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, d_expert=d_expert))
            batch = train.to_device(SyntheticTokens(cfg, DataConfig(
                batch=4, seq_len=64)).batch_at(0), torch.device("cpu"))
            losses, grads = [], []
            calls.clear()
            for sharded in (False, True):
                model = set_gates(Model(cfg, torch.device("cpu"),
                                        trainable=True).init_weights(0),
                                  *gate or (None,))
                b = batch
                ctx = contextlib.nullcontext()
                if sharded:
                    train.place_model(model, mesh, rules)
                    b = train.place_batch(batch, mesh, rules)
                    ctx = R.sharding_context(mesh, rules)
                opt = adamw.init_state(dict(model.named_parameters()))
                with ctx:
                    losses.append(float(make_train_step(
                        cfg, adamw.AdamWConfig())(model, opt, b)["loss"]))
                grads.append({n: R.unshard(p.grad).clone()
                              for n, p in model.named_parameters()})
            out[name] = {"loss": tuple(losses),
                         "differ": [n for n in grads[0] if not torch.equal(
                             grads[0][n], grads[1][n])],
                         "tokens_moved": bool(calls)}
    finally:
        moe._sharded_tokens = tokens
    return out


def family_runs(rank, world, trained, served, counted):
    """:func:`train_runs` of ``trained``, :func:`serve_runs` of ``served``
    and :func:`counted_train_steps` of ``counted``, in one spawn."""
    return (train_runs(rank, world, trained), serve_runs(rank, world, served),
            counted_train_steps(rank, world, counted))
