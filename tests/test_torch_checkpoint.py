"""The port's copies around the train loop against the JAX package: the
checkpoint manager (same files, same atomic commit, retention and async
writer; bf16 through its int16 bits), the straggler detector, the
synthetic data stream and the chrome-trace export."""
import json

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.checkpoint.straggler import StragglerDetector as JaxDetector
from repro.configs import archs as jax_archs
from repro.core import timeline as jax_timeline
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.straggler import StragglerDetector
from repro_torch.configs import archs as torch_archs
from repro_torch.core import timeline
from repro_torch.core.events import Event
from repro_torch.data.pipeline import DataConfig, SyntheticTokens


def state(n=3.0):
    return {
        "params": {"w": torch.full((4, 4), n), "b": torch.zeros(4),
                   "h": torch.full((2, 3), n, dtype=torch.bfloat16)},
        "opt_state": {"m": {"w": torch.ones(4, 4), "b": torch.zeros(4)},
                      "v": {"w": torch.ones(4, 4), "b": torch.zeros(4)},
                      "step": 7},
    }


def test_roundtrip_sync_keeps_values_and_dtypes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, state(), {"note": "x"})
    step, restored, meta = mgr.restore()
    assert step == 5 and meta["note"] == "x"
    assert meta["bfloat16"] == ["params/h"]
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 3.0))
    assert restored["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["h"], state()["params"]["h"])
    assert int(restored["opt_state"]["step"]) == 7


def test_files_are_the_jax_packages(tmp_path):
    # the same layout as the JAX manager's: it lists and reads our steps
    CheckpointManager(str(tmp_path), async_save=False).save(3, state())
    jmgr = JaxCheckpointManager(str(tmp_path), async_save=False)
    assert jmgr.available_steps() == [3]
    _, tree, meta = jmgr.restore()
    np.testing.assert_array_equal(tree["params"]["w"], np.full((4, 4), 3.0))
    assert tree["params"]["h"].dtype == np.int16 and meta["n_arrays"] == 8
    assert sorted(p.name for p in (tmp_path / "step_0000000003").iterdir()) \
        == ["COMMITTED", "arrays.npz", "metadata.json"]


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, state(float(s)))
    mgr.wait()
    assert mgr.available_steps() == [1, 2, 3]
    _, restored, _ = mgr.restore(2)
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 2.0))
    mgr.close()


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in range(5):
        mgr.save(s, state(float(s)))
    assert mgr.available_steps() == [3, 4]


def test_uncommitted_debris_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state())
    crash = tmp_path / "step_0000000009"
    crash.mkdir()
    (crash / "arrays.npz").write_bytes(b"garbage")
    assert mgr.available_steps() == [1]
    assert mgr.restore()[0] == 1


def test_restore_empty_dir(tmp_path):
    assert CheckpointManager(str(tmp_path), async_save=False).restore() is None


def test_failed_async_write_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr._write = lambda *a: (_ for _ in ()).throw(OSError("disk full"))
    mgr.save(1, state())
    with pytest.raises(RuntimeError, match="writer failed"):
        mgr.wait()
    mgr.close()


@pytest.mark.parametrize("durations,kind", [
    ([0.1] * 8 + [0.5] * 8, "straggler"),
    ([0.1] * 6 + [5.0], "failure"),
    ([0.1] * 20, None),
])
def test_straggler_detector_matches_jax(durations, kind):
    flagged = []
    for det in (StragglerDetector(), JaxDetector()):
        for i, d in enumerate(durations):
            det.record(rank=0, step=i, duration_s=d)
        flagged.append([(f.kind, f.message, str(f)) for f in det.flagged])
    assert flagged[0] == flagged[1]
    assert [k for k, _, _ in flagged[0]][:1] == ([kind] if kind else [])


@pytest.mark.parametrize("step", [0, 3])
def test_synthetic_tokens_match_jax(step):
    jd = JaxTokens(jax_archs.get_config("yi-6b", "smoke"),
                   JaxDataConfig(batch=3, seq_len=40))
    td = SyntheticTokens(torch_archs.get_config("yi-6b", "smoke"),
                         DataConfig(batch=3, seq_len=40))
    want, got = jd.batch_at(step), td.batch_at(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_chrome_trace_matches_jax(tmp_path):
    # the trace joins a region's path with "/", so these names have none
    events = [Event(name="step", path=("step",), category="app",
                    t_start=1000, t_end=5000, pid=0, tid=0,
                    attrs={"step": 1}),
              Event(name="compute", path=("step", "compute"),
                    category="api", t_start=1500, t_end=4000, pid=0, tid=0)]
    trace = timeline.to_chrome_trace(events)
    assert trace == jax_timeline.to_chrome_trace(events)
    path = str(tmp_path / "t.json.gz")
    timeline.save_trace(trace, path)
    back = timeline.from_chrome_trace(timeline.load_trace(path))
    assert [(e.name, e.path, e.t_start, e.t_end) for e in back] == [
        (e.name, e.path, e.t_start, e.t_end) for e in events]
    assert json.dumps(trace)
