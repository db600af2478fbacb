"""Replay the committed trace corpus against the current engine.

    PYTHONPATH=src python scripts/corpus_run_torch.py [--root tests/corpus]
        [--jobs N] [--entries id ...] [--mode MODE] [--json OUT]
        [--write-expectations]

The CI-grade regression gate over recorded communication signatures:
every manifest entry is hash-verified, replayed concurrently through
the current engine (one pool task per trace), and compared bit-for-bit
against its committed deterministic per-phase/per-rank stats and
detector findings. Any divergence prints a pointed ``align="label"``
trace diff and exits non-zero.

``--mode`` replays every entry under an engine-mode override — the
what-if sweep (expected to fail loudly against a defect mode; that is
the point). ``--write-expectations`` re-derives the manifest
expectations from the traces on disk after an *intentional*
engine-behavior change (``make corpus-baseline`` re-records the traces
themselves too).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "tests", "corpus")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help="corpus directory (default: tests/corpus)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker processes (default: usable cores; "
                         "1 = in-process)")
    ap.add_argument("--entries", nargs="*", default=None,
                    help="entry ids to run (default: all)")
    ap.add_argument("--mode", default=None,
                    help="engine-mode override for every entry "
                         "(what-if / divergence sweep)")
    ap.add_argument("--json", default=None,
                    help="write the machine-readable result here")
    ap.add_argument("--write-expectations", action="store_true",
                    help="re-derive manifest expectations from the "
                         "traces on disk, then exit")
    args = ap.parse_args()

    from repro_torch.corpus import (CorpusStore, InlinePool, ReplayPool,
                              refresh_expectations, run_corpus,
                              usable_cores)

    store = CorpusStore.load(args.root)
    if args.write_expectations:
        refresh_expectations(store)
        print(f"expectations refreshed for {len(store.entries)} "
              f"entries: {store.manifest_path}")
        return 0

    jobs = args.jobs if args.jobs is not None else usable_cores()
    pool = InlinePool() if jobs <= 1 else ReplayPool(jobs=jobs)
    try:
        result = run_corpus(store, pool=pool, entries=args.entries,
                            mode_override=args.mode)
    finally:
        pool.close()

    print(result.render())
    print()
    print(result.report.render(limit=8))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result.to_json(), f, indent=1, sort_keys=True)
        print(f"\nresult written: {args.json}")
    if not result.ok:
        print(f"\nCORPUS GATE FAILED: {len(result.failures)} failure(s)",
              file=sys.stderr)
        return 1
    print(f"\ncorpus gate passed: {len(result.results)} entries clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
