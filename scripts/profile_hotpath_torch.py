"""Profile the hotpath bench inner loop and dump the evidence.

    PYTHONPATH=src python scripts/profile_hotpath_torch.py [--smoke]
                                                     [--mode binned]
                                                     [--drives N]
                                                     [--top N]

Runs ``repro.workloads.hotpath.drive_scenario`` for every scenario
under cProfile (current engine only — the frozen legacy comparator is
not what the next perf PR will optimize) and writes the top-N
cumulative-time rows to ``results/bench/profile.txt`` so perf work
starts from evidence, not guesses (``make profile-hotpath``).
"""
from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized scenario parameters")
    ap.add_argument("--mode", default="binned",
                    help="engine mode to profile (default: binned)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drives", type=int, default=5,
                    help="profiled drives per scenario")
    ap.add_argument("--top", type=int, default=20,
                    help="rows of the cumulative-time dump")
    ap.add_argument("--out", default=None,
                    help="output path (default: "
                         "results/bench/profile.txt)")
    args = ap.parse_args()
    size = "smoke" if args.smoke else "full"

    from repro_torch.workloads.base import all_scenarios
    from repro_torch.workloads.hotpath import drive_scenario

    scenarios = all_scenarios()
    # one untimed warm-up drive per scenario: plan caches, rng-stream
    # memos and lazy numpy columns settle so the profile shows the
    # steady state the bench gates on
    for sc in scenarios:
        drive_scenario(sc, args.mode, size=size, seed=args.seed)

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(max(1, args.drives)):
        for sc in scenarios:
            drive_scenario(sc, args.mode, size=size, seed=args.seed)
    prof.disable()

    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf)
    stats.strip_dirs().sort_stats("cumulative").print_stats(args.top)
    text = (f"hotpath profile: size={size} mode={args.mode} "
            f"drives={args.drives} seed={args.seed}\n" + buf.getvalue())

    out = args.out or os.path.join(REPO, "results", "bench",
                                   "profile.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(text)
    print(text)
    print(f"profile saved: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
