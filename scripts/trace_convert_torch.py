"""Re-encode a repro.trace JSONL trace between schema versions.

    PYTHONPATH=src python scripts/trace_convert_torch.py IN OUT [--schema {2,3}]
                                                          [--check]
                                                          [--lenient]

Streams the source trace (any supported version — v1/v2 per-op, v3
chunked) through a writer at the target schema: records, ``t_wall``
stamps, phase markers, snapshots and header meta pass through
unchanged; only the post/arrive encoding differs. v2 -> v3 -> v2 is
byte-identical; v3 compacts the op stream into delta-encoded columnar
chunks (typically 3-5x fewer bytes/op on scenario traces).

``--check`` replays both files (same engine mode, batched) and verifies
the per-phase/per-rank deterministic counter statistics and detector
findings are equal — the replay-stat round-trip guarantee the perf gate
(``benchmarks/replay_bench.py``) enforces fleet-wide.

**Directory mode**: when IN is a directory, every ``*.jsonl`` /
``*.jsonl.gz`` in it is converted into the directory OUT (created if
missing, same file names), with per-file ``--check`` applied and a
summary line per file; the exit status is non-zero if *any* file fails
— bulk-migrating a trace corpus is one command.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="input trace (.jsonl or .jsonl.gz)")
    ap.add_argument("dst", help="output trace path")
    ap.add_argument("--schema", type=int, default=None,
                    help="target schema version (default: 3, the "
                         "compact chunked encoding; 2 = per-op records)")
    ap.add_argument("--check", action="store_true",
                    help="replay both traces and verify stat equality")
    ap.add_argument("--lenient", action="store_true",
                    help="salvage a damaged source: skip corrupt lines "
                         "(dropped from the output, tallied per "
                         "category) instead of aborting")
    args = ap.parse_args()

    from repro_torch.trace import convert_trace, replay
    from repro_torch.workloads.replaybench import (finding_kinds,
                                             phase_signature)

    def convert_one(src: str, dst: str) -> bool:
        skipped: dict = {}
        n_records, n_ops = convert_trace(src, dst, schema=args.schema,
                                         strict=not args.lenient,
                                         skipped=skipped)
        s_in = os.path.getsize(src)
        s_out = os.path.getsize(dst)
        print(f"{src} -> {dst}: {n_records} records "
              f"({n_ops} engine ops), {s_in:,} -> {s_out:,} bytes "
              f"({s_in / max(s_out, 1):.2f}x)")
        if skipped:
            print("  lenient: skipped "
                  + ", ".join(f"{n} {cat} line(s)"
                              for cat, n in sorted(skipped.items())))
        if args.check:
            a = replay(src, check_matches=False)
            b = replay(dst, check_matches=False)
            ok = (phase_signature(a) == phase_signature(b)
                  and finding_kinds(a) == finding_kinds(b)
                  and a.n_ops == b.n_ops)
            if not ok:
                print(f"CHECK FAILED: replay statistics differ between "
                      f"{src} and {dst}")
                return False
            print(f"  check passed: {len(a.phases)} phases, {a.n_ops} "
                  f"ops — replay stats and findings identical")
        return True

    if os.path.isdir(args.src):
        names = sorted(n for n in os.listdir(args.src)
                       if n.endswith((".jsonl", ".jsonl.gz")))
        if not names:
            print(f"no traces (*.jsonl[.gz]) in {args.src}")
            return 1
        if os.path.exists(args.dst) and not os.path.isdir(args.dst):
            print(f"{args.src} is a directory, so {args.dst} must be one")
            return 1
        os.makedirs(args.dst, exist_ok=True)
        bad = [n for n in names
               if not convert_one(os.path.join(args.src, n),
                                  os.path.join(args.dst, n))]
        print(f"\n{len(names) - len(bad)}/{len(names)} traces converted"
              + (f", {len(bad)} FAILED: {bad}" if bad else ""))
        return 1 if bad else 0

    return 0 if convert_one(args.src, args.dst) else 1


if __name__ == "__main__":
    sys.exit(main())
