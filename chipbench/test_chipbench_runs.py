"""Runs of every cell at smoke size on the CPU: the result line, the
modules loaded, the faults the check must catch, and the control.

A run that looks for the card exits non-zero here; ``--smoke`` skips
that look and drives the rest of the run on the CPU at the smoke sizes
of its configuration and traffic mix. The faults are planted in the
program underneath a run driven in this process; ``correct`` must come
out false for each."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVE = [w["name"] for w in BENCH["workloads"]
         if json.loads((ROOT / "chipbench" / "traffic" /
                        f"{w['traffic']}.json").read_text())["kind"] == "serve"]
TRAIN = [c for c in CELLS if c not in SERVE]


def _run(*argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chipbench/run.py", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=240)


@pytest.mark.parametrize("cell", CELLS)
def test_a_smoke_run_prints_a_well_formed_last_line(cell):
    p = _run("--workload", cell, "--seed", str(2**31 + 12345),
             "--seconds", "0.2", "--trace", "0", "--smoke")
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    last = p.stderr.strip().splitlines()[-len(out["checks"]):]
    for line, (k, v) in zip(last, out["checks"].items()):
        assert line == f"check {k} {v['value']!r} limit {v['limit']!r}"


def test_no_card_means_no_result():
    p = _run("--workload", CELLS[0], "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in BENCH["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "0.2",
                        "--smoke"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_jax_and_no_jax_package_is_loaded():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from chipbench import cells, run;"
        "rc = run.main(['--workload', %r, '--seed', '3', '--seconds', '0.1',"
        " '--smoke']);"
        "import chipbench.readers, chipbench.tracing;"
        "[run.metric_reader(m['name']) for m in cells.benchmark()['per_layer']];"
        "tops = {m.split('.', 1)[0] for m in list(sys.modules)};"
        "print('TOPS', sorted(tops & {'jax', 'jaxlib', 'flax', 'repro'}));"
        "print('TORCH', 'repro_torch' in tops); sys.exit(rc)") % TRAIN[0]
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    assert "TOPS []" in p.stdout and "TORCH True" in p.stdout


def test_the_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import chipbench.reference.dense, chipbench.reference.hybrid,"
            " chipbench.reference.adamw, chipbench.reference.common;"
            "tops = {m.split('.', 1)[0] for m in list(sys.modules)};"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro',"
            " 'repro_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


class _Ctx:
    """The run's context on the CPU, as ``--smoke`` makes it."""

    def __init__(self):
        import time

        from chipbench.run import Context

        self._ctx = Context(True)
        self._ctx.t_start = time.perf_counter()

    def __getattr__(self, name):
        return getattr(self._ctx, name)


def _drive(cell: str, seed: int, **extra):
    """A run of ``cell`` at smoke size in this process, past the look for
    a card: (correct, checks)."""
    from chipbench import cells, check

    c = cells.cell(cell)
    driver = __import__(f"chipbench.{c['traffic_file']['kind']}",
                        fromlist=["run"])
    args = types.SimpleNamespace(seed=seed, seconds=0.2, trace=0,
                                 control=False, fault=None)
    args.__dict__.update(extra)
    out = driver.run(c, args, _Ctx())
    limits = cells.sized(c["limits_file"], True)
    return check.within(out["readings"], limits), out


@pytest.mark.parametrize("cell", SERVE)
def test_a_token_altered_where_it_is_produced_fails(cell, monkeypatch):
    import repro_torch.launch.serve as serve

    real = serve.generate

    def altered(model, prompts, gen, captured=True):
        out, stats = real(model, prompts, gen, captured)
        out = out.clone()
        out[-1, -1] = (out[-1, -1] + 1) % model.cfg.vocab_size
        return out, stats

    monkeypatch.setattr(serve, "generate", altered)
    ok, _ = _drive(cell, 21)
    assert not ok


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(cell, monkeypatch):
    import repro_torch.train.step as step_mod

    real = step_mod.make_train_step

    def frozen(cfg, opt_cfg, microbatches=1):
        step = real(cfg, opt_cfg, microbatches)

        def no_update(model, state, batch):
            saved = [p.detach().clone() for p in model.parameters()]
            saved_m = {k: t.clone() for k, t in state["m"].items()}
            saved_v = {k: t.clone() for k, t in state["v"].items()}
            metrics = step(model, state, batch)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
                for k in saved_m:
                    state["m"][k].copy_(saved_m[k])
                    state["v"][k].copy_(saved_v[k])
            return metrics

        return no_update

    monkeypatch.setattr(step_mod, "make_train_step", frozen)
    ok, out = _drive(cell, 22)
    assert not ok and out["readings"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_fails(cell):
    ok, out = _drive(cell, 23, fault="half_batch")
    assert not ok


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell):
    """The control (the reference in fp8, in the program's place) reads
    above the limit at smoke size, where the program reads within it."""
    ok, out = _drive(cell, 24, control=True)
    from chipbench import cells, check

    limits = cells.sized(cells.cell(cell)["limits_file"], True)
    assert ok and not check.within(out["control"], limits)


def test_the_control_on_the_card():
    """The control at each cell's own size on the card (three seeds),
    beside the program's readings: the comparison that set the limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
            p = subprocess.run(
                [sys.executable, "chipbench/run.py", "--workload", cell,
                 "--seed", str(seed), "--seconds", "5", "--trace", "0",
                 "--control"], cwd=ROOT, capture_output=True, text=True,
                timeout=900)
            assert p.returncode == 0, p.stderr[-4000:]
            out = json.loads(p.stdout.strip().splitlines()[-1])
            limits = {k: v["limit"] for k, v in out["checks"].items()}
            from chipbench.check import within

            assert out["correct"] and not within(out["control"], limits)
