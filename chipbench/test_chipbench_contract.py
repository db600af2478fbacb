"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, and what each cell reports. No device, no model."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "chipbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _width(key: str) -> bool:
    """A width by the contract: a size (but the vocabulary's), a key that
    ends in _dim or _rank, a state size, an expansion factor, the experts
    a token takes."""
    return ((key.endswith(("_size", "_dim", "_rank")) and key != "vocab_size")
            or any(w in key for w in ("expand", "experts_per_tok", "d_state")))


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    paths = BENCH["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).is_file()


def test_every_file_name_under_paths_is_made_of_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["why"])
    assert _line(entry["source"]) and entry["source"].startswith("https://")
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == entry["name"] and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not _width(key), key
        assert data["published"][key] != data[key]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert (HERE / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (HERE / "limits" / f"{cell['name']}.json").is_file()
    name = cell["name"]
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(name in m.get("workloads", [name]) for m in BENCH["per_layer"])


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in moves.get("workloads", cells)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fit_the_check_with_24_cells():
    per_run = BENCH["run_seconds"] + 60
    total = (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200
    assert total <= 43200
