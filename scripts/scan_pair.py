"""Time the port's selective-scan kernels and the jamba train step of one or
more trees on one card, in turns, each tree through its own
``chip_smoke.py``.

    python3 scripts/scan_pair.py PARENT CHANGE CHANGE PARENT
    python3 scripts/scan_pair.py --no-train CHANGE

Each argument is a directory holding ``chip_smoke.py`` and
``src/repro_torch`` (a checkout, or a ``git archive`` of a commit
unpacked). For each, in the order given, a fresh Python process imports
that tree's ``chip_smoke.py`` and runs its phases 1 and 2 (the card, the
build with what ptxas says), 10 and 11 (the scan forward against its plain
version, its time at the serving shape), then times the forward at the
training shape with and without its saved states, turn about, then runs
phase 28 (the scan backward against the plain backward on the six cases,
bit for bit, its time at B 4, T 1024, d_inner 8192, d_state 16) and,
unless ``--no-train``, phase 28's jamba training (one pattern group at
full width, d_expert 1024) for ``TRAIN_STEPS`` steps instead of the
phase's 4: step ms (the median after the first), peak memory, and the
scan kernels' device ms in the profiled step. Each run prints one JSON
line ``{"tree": ..., ...}``; the last line gathers them. Needs a card;
exits non-zero if any run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TRAIN_STEPS = 10


def child(tree: str, train: bool) -> dict:
    """The measurements of one tree, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs

    cs.T0 = time.perf_counter()
    cs.setup()
    import torch

    from repro_torch.kernels.mamba_scan import kernel

    kind, count, card, sms, clock_hz = cs.card_info()
    cs.CARD = card
    print(f"[1] {kind} (count {count}), torch {torch.__version__}; {card}",
          flush=True)
    reports = cs.build_phase()
    scan = cs.scan_phases(sms, clock_hz)
    # the forward at the training shape: serving (no saved states) and
    # training (saved states), turn about
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = cs.scan_inputs(cs.SCAN_SERVING, gen)
    serve = lambda: kernel.selective_scan(*args, return_state=True)
    train_fwd = lambda: kernel.selective_scan(*args, return_state=True,
                                              save_chunks=True)
    fwd = {"serve_ms": [], "train_ms": []}
    for _ in range(2):
        fwd["serve_ms"].append(cs.cuda_ms(serve))
        fwd["train_ms"].append(cs.cuda_ms(train_fwd))
    saved = train_fwd()[2]
    fwd["saved_state_bytes"] = saved.numel() * 4
    del args, saved
    torch.cuda.empty_cache()
    print(f"[fwd] serving {fwd['serve_ms']} ms, training (saves "
          f"{fwd['saved_state_bytes']} B) {fwd['train_ms']} ms; {card}",
          flush=True)
    bwd = cs.scan_backward_phase(sms, clock_hz, reports)
    out = {"tree": tree, "card": card, "forward": fwd,
           "forward_phase11": scan["timing"], "backward": bwd["timing"],
           "backward_errors": {k: v for k, v in bwd.items()
                               if k not in ("timing", "phase_s")}}
    if train:
        B, T, _ = cs.JAMBA_TRAIN
        cs.JAMBA_TRAIN = (B, T, TRAIN_STEPS)
        counts, numbers = cs.jamba_train_phase()
        trace = numbers["trace"]
        out["jamba_train"] = {
            k: numbers[k] for k in ("step_ms", "mean_step_ms",
                                    "tokens_per_s", "peak_memory_bytes",
                                    "launches_per_step")}
        out["jamba_train"].update(
            median_step_ms=statistics.median(numbers["step_ms"][1:]),
            launches=counts, check=numbers["check"],
            traced={k: trace[k] for k in ("wall_ms", "busy_ms",
                                          "idle_share")},
            traced_scan_kernels={k["name"]: (k["ms"], k["launches"])
                                 for k in trace["kernels"]
                                 if "selective_scan" in k["name"]})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="directories holding "
                    "chip_smoke.py and src/repro_torch, run in this order")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the jamba training")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.trees[0], not a.no_train)), flush=True)
        return
    runs, failed = [], []
    for tree in a.trees:
        t0 = time.perf_counter()
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree]
        if a.no_train:
            cmd.append("--no-train")
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.strip().splitlines()
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0 or not lines:
            failed.append(tree)
            continue
        run = json.loads(lines[-1])
        run["seconds"] = time.perf_counter() - t0
        runs.append(run)
    summary = [{"tree": r["tree"],
                "bwd_ms": [r["backward"]["ms"], r["backward"]["ms_again"]],
                "bwd_share_of_bound": r["backward"]["bound_ms"]
                / r["backward"]["ms"],
                "fwd_serve_ms": r["forward"]["serve_ms"],
                "fwd_train_ms": r["forward"]["train_ms"],
                "jamba_median_step_ms": r.get("jamba_train", {}).get(
                    "median_step_ms"),
                "jamba_traced_busy_ms": r.get("jamba_train", {}).get(
                    "traced", {}).get("busy_ms"),
                "jamba_traced_scan_kernels": r.get("jamba_train", {}).get(
                    "traced_scan_kernels"),
                "jamba_peak_bytes": r.get("jamba_train", {}).get(
                    "peak_memory_bytes"),
                "seconds": r["seconds"]} for r in runs]
    print(json.dumps({"runs": summary, "failed": failed}), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
