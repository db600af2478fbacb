"""Build variants of the port's selective-scan backward kernel from this
checkout's sources and time each at jamba's training shape on one card.

    python3 scripts/scan_bwd_variants.py            # every variant
    python3 scripts/scan_bwd_variants.py "P = 1" "as committed"

A variant is a copy of ``src/repro_torch/kernels/mamba_scan/csrc`` with
the text replacements of ``VARIANTS`` applied (each must match, so a stale
one fails loudly) or, for one, rewritten by a function, built with
``nvcc`` and the port's flags into ``build/scan_variants/<n>/``, one
``nvcc`` a source, all started together.
The forward is built from the same copy, since the saved states' cadence
lives in ``scan.cuh``. Each variant then runs through the port's own
ctypes wrappers at B 4, T 1024, d_inner 8192, d_state 16 (x bf16,
dt/B/C f32): its gradients against the plain backward (max|err| /
max|ref|; a diagnostic variant drops work and is only timed) and its time
by CUDA events, two rounds with the variants in turns. Prints ptxas's
registers and spills, one line a variant a round, and a JSON summary as
its last line. Needs a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "mamba_scan",
                    "csrc")
OUT = os.path.join(ROOT, "build", "scan_variants")
BWD = "selective_scan_bwd.cu"

_P = "  constexpr int P = 4;  "
_NO_SUMS = [
    (BWD, "  const bool hi4 = lane & 16, hi3 = lane & 8, hi2 = lane & 4;\n",
     "  for (int p = 0; p < P; ++p) r[p] = v[p][0] + v[p][7];\n  return;\n"
     "  const bool hi4 = lane & 16, hi3 = lane & 8, hi2 = lane & 4;\n"),
    (BWD, "r[p] += __shfl_xor_sync(FULL, odd ? sum_dx[p] : sum_ddt[p], 1);",
     "r[p] += odd ? sum_dx[p] : sum_ddt[p];"),
    (BWD, "if constexpr (L == 4) r[p] += __shfl_xor_sync(FULL, r[p], 2);",
     "if constexpr (L == 4) r[p] += 1.f;"),
]


def _tiles_of_16(d: str) -> None:
    """The backward on staged tiles of 16 steps (half the shared memory),
    the states saved every 8 steps and two blocks an SM asked of ptxas (at
    most 128 registers a thread)."""
    def edit(fname, fn):
        path = os.path.join(d, fname)
        text = fn(open(path).read())
        open(path, "w").write(text)

    def header(text):
        for old, new in (
                ("template <typename T, int CHUNK>\n", "template <typename T, "
                 "int CHUNK, int ROWS = TT>\n"),
                ("i < TT * per_row;", "i < ROWS * per_row;"),
                ("i < TT * cols;", "i < ROWS * cols;"),
                ("int SAVE_EVERY = 16;", "int SAVE_EVERY = 8;")):
            if old not in text:
                raise SystemExit(f"tiles of 16: {old!r} not in scan.cuh")
            text = text.replace(old, new)
        return text

    def backward(text):
        head, body = text.split('#include "scan.cuh"', 1)
        body = re.sub(r"\bTT\b", "BT", body)
        body = body.replace("namespace {\n", "namespace {\n\nconstexpr int BT "
                            "= 16;\n", 1)
        body = re.sub(r"stage_rows<(TX|TP), (16|BC_CHUNK)>\(",
                      r"stage_rows<\1, \2, BT>(", body)
        old = "__launch_bounds__(CH * N / 4)\n"
        if old not in body:
            raise SystemExit(f"tiles of 16: {old!r} not in {BWD}")
        body = body.replace(old, "__launch_bounds__(CH * N / 4, 2)\n")
        return head + '#include "scan.cuh"' + body

    edit("scan.cuh", header)
    edit(BWD, backward)


# dx and ddt stored to device memory from the walk, each under a predicate
# (the lane that holds the sum, a step before T), as the first cut stored
# them, one step at a time
_PREDICATED = [
    (BWD, _P, "  constexpr int P = 1;  "),
    (BWD, """          out[s * CH] = odd ? r[p] : fmaf(dtvs[p], r[p], ddy[p]);
          if constexpr (L == 1) out[TT * CH + s * CH] = sum_ddt[p];
""", """          const int64_t at = row + static_cast<int64_t>(t0 + s) * dI + d;
          if (active && t0 + s < T_len) {
            if (!odd && j < 2)
              dx[at] = from_f32<TX>(fmaf(dtvs[p], r[p], ddy[p]));
            if (L == 1 || j == 1)
              ddt[at] = from_f32<TP>(L == 1 ? sum_ddt[p] : r[p]);
          }
"""),
    (BWD, """        dx[at] = from_f32<TX>(sout[k]);
        ddt[at] = from_f32<TP>(sout[TT * CH + k]);
""", ""),
]
# name: ([(file, text, replacement)] or a function of the directory,
# diagnostic)
VARIANTS = {
    "as committed": ([], False),
    "P = 1": ([(BWD, _P, "  constexpr int P = 1;  ")], False),
    "P = 2": ([(BWD, _P, "  constexpr int P = 2;  ")], False),
    "P = 8": ([(BWD, _P, "  constexpr int P = 8;  ")], False),
    "dx, ddt stored under a predicate, P = 1": (_PREDICATED, False),
    "saves every 8 steps": ([("scan.cuh", "constexpr int SAVE_EVERY = 16;",
                              "constexpr int SAVE_EVERY = 8;")], False),
    "tiles of 16, saves every 8, two blocks an SM": (_tiles_of_16, False),
    "no lane sums (diagnostic)": (_NO_SUMS, True),
    "no ex2 (diagnostic)": ([(BWD, "a[v][k] = ex2(dtv * a2[k]);",
                              "a[v][k] = fmaf(dtv, a2[k], 1.f);")], True),
}


def make(names):
    """Copy and patch each variant's sources, then build them all; returns
    {name: (directory, saved-state cadence)}."""
    from repro_torch.kernels import build

    dirs, procs = {}, []
    for i, name in enumerate(names):
        d = os.path.join(OUT, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        patches = VARIANTS[name][0]
        if callable(patches):
            patches(d)
            patches = []
        for fname, old, new in patches:
            path = os.path.join(d, fname)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in {fname}")
            open(path, "w").write(text.replace(old, new))
        every = int(re.search(r"int SAVE_EVERY = (\d+);", open(
            os.path.join(d, "scan.cuh")).read()).group(1))
        dirs[name] = (d, every)
        for src in ("selective_scan", "selective_scan_bwd"):
            procs.append((name, src, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o",
                 os.path.join(d, f"lib{src}.so"),
                 os.path.join(d, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, src, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r}: nvcc failed on {src}:\n"
                             f"{err[-4000:]}")
        if src == "selective_scan_bwd":
            regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                               out + err)]
            spills = [int(r) for r in re.findall(
                r"(\d+) bytes spill stores", out + err)]
            dirs[name] += (regs, spills)
            print(f"{name}: backward ptxas registers {regs}, spill stores "
                  f"{spills}", flush=True)
    return dirs


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"no variant {name!r}; have {list(VARIANTS)}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import kernel, ref

    t0 = time.perf_counter()
    dirs = make(names)
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, T, dI, N = 4, 1024, 8192, 16
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rn(B, T, dI).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rn(B, T, dI) - 2)
    args = (x, dt, -torch.exp(rn(dI, N) * 0.5), rn(B, T, N), rn(B, T, N),
            rn(dI))
    dy = rn(B, T, dI).to(torch.bfloat16)
    want = ref.selective_scan_bwd_ref(*args, dy)
    load, every0 = build.load, kernel.SAVE_EVERY
    results = {}
    try:
        for rnd in range(2):
            for name in names:
                d, every, regs, spills = dirs[name]
                kernel.SAVE_EVERY = every
                build.load = lambda n, d=d: ctypes.CDLL(
                    os.path.join(d, f"lib{n}.so"))
                kernel._library.cache_clear()
                kernel._bwd_library.cache_clear()
                _, _, chunks = kernel.selective_scan(*args, save_chunks=True)
                got = kernel.selective_scan_bwd(*args, dy, chunks)
                torch.cuda.synchronize()
                err = max(float((a.float() - b.float()).abs().max()
                                / b.float().abs().max())
                          for a, b in zip(got, want))
                run = lambda: kernel.selective_scan_bwd(*args, dy, chunks)
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(20):
                    run()
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / 20
                smem, blocks = kernel.selective_scan_info(
                    N, torch.bfloat16, torch.float32, backward=True)
                r = results.setdefault(name, {
                    "ms": [], "worst_rel_err": err,
                    "diagnostic": VARIANTS[name][1], "saves_every": every,
                    "saved_state_bytes": chunks.numel() * 4,
                    "registers": regs, "spill_stores": spills,
                    "smem": smem, "blocks_per_sm": blocks})
                r["ms"].append(ms)
                print(f"round {rnd}: {name}: {ms:.3f} ms, worst gradient "
                      f"max|err|/max|ref| {err:.2e}, {smem} B shared "
                      f"memory, {blocks} blocks an SM; {smi}", flush=True)
                del chunks, got
                torch.cuda.empty_cache()
    finally:
        build.load, kernel.SAVE_EVERY = load, every0
        kernel._library.cache_clear()
        kernel._bwd_library.cache_clear()
    bad = [n for n, r in results.items()
           if not r["diagnostic"] and r["worst_rel_err"] >= 2e-2]
    print(json.dumps({"card": smi, "shape": "B=4 T=1024 dI=8192 N=16 x bf16"
                      " dt/B/C f32", "variants": results,
                      "wrong": bad}), flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
