"""The ported scripts and examples (``scripts/*_torch.py``,
``examples/*_torch.py``) run on the CPU, each in a subprocess; where the
JAX driver's output is deterministic (``trace_convert``, ``corpus_run``,
``make_trace_goldens --corpus``), the port's is byte for byte the same.
The examples that touch a device get ``--device cpu``."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ["alltoall_transpose__fifo", "amg_coarsen__linear",
           "elastic_ranks__leaky_umq"]


def run(rel, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + ":" + REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, rel), *args],
                         capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=REPO)
    assert out.returncode == 0, (rel, out.stdout[-3000:], out.stderr[-3000:])
    return out.stdout


def test_trace_convert_writes_the_references_bytes(tmp_path):
    src = os.path.join(REPO, "tests", "corpus", "amg_coarsen__fifo.jsonl")
    for schema in ("2", "3"):
        a, b = tmp_path / f"jax{schema}.jsonl", tmp_path / f"torch{schema}.jsonl"
        run("scripts/trace_convert.py", src, str(a), "--schema", schema)
        out = run("scripts/trace_convert_torch.py", src, str(b), "--schema",
                  schema, "--check")
        assert "check passed" in out
        assert a.read_bytes() == b.read_bytes()


def test_trace_convert_directory_mode(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    for e in ENTRIES[:2]:
        (src / f"{e}.jsonl").write_bytes(
            open(os.path.join(REPO, "tests", "corpus", f"{e}.jsonl"),
                 "rb").read())
    out = run("scripts/trace_convert_torch.py", str(src),
              str(tmp_path / "out"), "--schema", "2", "--check")
    assert "2/2 traces converted" in out


def test_corpus_run_gives_the_references_result(tmp_path):
    a, b = tmp_path / "jax.json", tmp_path / "torch.json"
    run("scripts/corpus_run.py", "--jobs", "1", "--entries", *ENTRIES,
        "--json", str(a))
    out = run("scripts/corpus_run_torch.py", "--jobs", "1", "--entries",
              *ENTRIES, "--json", str(b))
    assert f"corpus gate passed: {len(ENTRIES)} entries clean" in out
    assert a.read_bytes() == b.read_bytes()
    assert len(json.loads(b.read_text())["entries"]) == len(ENTRIES)


def test_make_trace_goldens_seeds_the_references_corpus(tmp_path):
    run("scripts/make_trace_goldens.py", "--corpus", "--corpus-dir",
        str(tmp_path / "jax"))
    run("scripts/make_trace_goldens_torch.py", "--corpus", "--corpus-dir",
        str(tmp_path / "torch"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert "manifest.json" in names and len(names) > 20
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (
            tmp_path / "torch" / n).read_bytes(), n


def test_profile_hotpath_writes_its_profile(tmp_path):
    out = tmp_path / "profile.txt"
    run("scripts/profile_hotpath_torch.py", "--smoke", "--drives", "1",
        "--top", "5", "--out", str(out))
    assert "cumulative" in out.read_text()


def test_quickstart_trains_and_writes_a_trace():
    out = run("examples/quickstart_torch.py", "--device", "cpu",
              "--steps", "3")
    assert out.count("loss") >= 3 and "train/compute" in out
    assert "chrome trace written" in out


def test_train_e2e_trains_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = run("examples/train_e2e_torch.py", "--device", "cpu", "--steps",
              "3", "--ckpt-dir", ckpt)
    assert "e2e tiny: loss" in out and "over 3 steps" in out
    out = run("examples/train_e2e_torch.py", "--device", "cpu", "--steps",
              "5", "--ckpt-dir", ckpt, "--resume")
    assert "resumed from step 3" in out and "over 2 steps" in out


@pytest.mark.parametrize("tour,args,expect", [
    ("matching_tour_torch", ["--device", "cpu"], "mode=linear"),
    ("replay_tour_torch", ["--device", "cpu"], "measured match latency"),
    ("telemetry_tour_torch", [], "umq_flood seen on"),
])
def test_tours_run(tour, args, expect):
    out = run(f"examples/{tour}.py", *args)
    assert "tour complete" in out or tour == "telemetry_tour_torch"
    assert expect in out
