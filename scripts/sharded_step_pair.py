"""Time the yi-6b train step on plain tensors and on DTensors over a one-rank
(1,1) NCCL mesh (``chip_smoke.py`` phase 31's cell) for one or more trees
on one card, in turns.

    python3 scripts/sharded_step_pair.py PARENT CHANGE CHANGE PARENT

Each argument is a directory holding ``src/repro_torch`` (a checkout, or a
``git archive`` of a commit unpacked). For each, in the order given, a
fresh Python process puts that tree's ``src`` on its path, builds the
kernels, and trains yi-6b at full width and 8 of its 32 layers (B 4, T
1024, bf16 compute, f32 masters, full remat, seed-0 weights, the
launcher's batches) for ``STEPS`` steps on plain tensors, then as many on
DTensors placed by the sharding rules on a (1,1) mesh of a one-rank NCCL
group (from a ``FileStore`` in a temporary directory). Each run prints one
JSON line ``{"tree": ..., "plain_ms": [...], "sharded_ms": [...]}`` (host
clock to the loss read back); the last line gathers them with the medians
after the first step. Needs a card; exits non-zero if any run fails.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

STEPS = 6
LAYERS, BATCH, SEQ = 8, 4, 1024


def child(tree: str) -> dict:
    """The step times of one tree, in this process."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs.archs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    from repro_torch.train.step import make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("yi-6b", "full"), n_layers=LAYERS)
    data = SyntheticTokens(cfg, DataConfig(batch=BATCH, seq_len=SEQ))
    tmp = tempfile.mkdtemp(prefix="sharded_step_pair_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    out = {"tree": tree, "card": torch.cuda.get_device_name(0)}
    try:
        mesh = make_mesh_for(1, 1, "cuda")
        rules = R.make_rules(mesh)
        for mode in ("plain", "sharded"):
            gc.collect()
            torch.cuda.empty_cache()
            model = Model(cfg, dev, trainable=True).init_weights(0)
            if mode == "sharded":
                train.place_model(model, mesh, rules)
            opt = adamw.init_state(dict(model.named_parameters()))
            step = make_train_step(cfg, adamw.AdamWConfig())
            times = []
            for i in range(STEPS):
                batch = train.to_device(data.batch_at(i), dev)
                if mode == "sharded":
                    batch = train.place_batch(batch, mesh, rules)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "sharded":
                    with R.sharding_context(mesh, rules):
                        float(step(model, opt, batch)["loss"])
                else:
                    float(step(model, opt, batch)["loss"])
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{mode}_ms"] = times
            del model, opt, step
    finally:
        dist.destroy_process_group()
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    runs = []
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--child", tree],
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            return 1
        run = json.loads(lines[-1])
        for mode in ("plain", "sharded"):
            run[f"{mode}_median_ms"] = statistics.median(run[f"{mode}_ms"][1:])
        print(json.dumps(run), flush=True)
        runs.append(run)
    print(json.dumps({"runs": [{k: r[k] for k in (
        "tree", "plain_median_ms", "sharded_median_ms")} for r in runs],
        "card": card.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
