"""The port's live telemetry (``repro_torch.telemetry``) against the JAX
package's (``repro.telemetry``), and ``serve --telemetry`` on the CPU.

The frame codec round-trips and encodes as the reference does; malformed
frames are refused; the bridge's frames (deltas, no-loss metadata and
live findings) on a scenario run are the reference bridge's once the
wall-clock stamps and measured times are dropped; the HTTP endpoints
answer; and the port's serving entry point with ``--telemetry`` serves
the same tokens as without it while the bridge polls the global counter
registry and watches the region collector.
"""
import json
import random
import threading
import urllib.error
import urllib.request

import pytest
import torch

from repro import telemetry as jax_telemetry
from repro import workloads as jax_workloads
from repro.core.counters import CounterRegistry as JaxCounterRegistry
from repro_torch import telemetry, workloads
from repro_torch.core.collector import global_collector
from repro_torch.core.counters import (CounterRegistry, CounterStat,
                                       global_registry, lane_events,
                                       reset_global_registry)
from repro_torch.launch import serve
from repro_torch.telemetry import (FRAME_DELTA, FRAME_END, FRAME_FINDING,
                                   FRAME_HEADER, TelemetryBridge, TelemetryFrameError,
                                   TelemetryServer)
from repro_torch.telemetry.server import _Handler

SERVE_ARGS = ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
              "--gen", "3"]


def _produce(reg, pid, n, base=0):
    lane = reg.lane(pid)
    for i in range(n):
        lane.count("match.posted")
        lane.observe("match.umq.length", base + i % 17)


def _timeless(obj):
    """A frame (or list of frames) without its wall-clock ``ts`` stamps
    and measured ``*_ns`` counters."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if k != "ts" and not k.endswith("_ns")}
    if isinstance(obj, list):
        return [_timeless(v) for v in obj]
    return obj


def test_format_identifiers_are_the_reference():
    assert telemetry.TELEMETRY_FORMAT == jax_telemetry.TELEMETRY_FORMAT \
        == "repro-telemetry"
    assert telemetry.TELEMETRY_SCHEMA == jax_telemetry.TELEMETRY_SCHEMA
    assert _Handler.server_version == "repro-telemetry/1"
    assert telemetry.DEFAULT_PERIOD_S == jax_telemetry.DEFAULT_PERIOD_S


@pytest.mark.parametrize("values,observation", [
    ((2, 5), False), ((1, 3, 3, 900), True), ((0.5, 7.25), True)],
    ids=["counter", "histogram", "fractional"])
def test_stat_codec_round_trips_as_the_reference(values, observation):
    st = CounterStat(name="x")
    for v in values:
        st.add(v, observation=observation)
    enc = json.loads(json.dumps(telemetry.encode_stat(st)))
    back = telemetry.decode_stat("x", enc)
    assert (back.kind, back.count, back.total, back.vmin, back.vmax,
            back.bins) == (st.kind, st.count, st.total, st.vmin, st.vmax,
                           st.bins)
    ref = jax_telemetry.decode_stat("x", enc)
    assert jax_telemetry.encode_stat(ref) == enc


def test_lanes_codec_round_trips_as_the_reference():
    reg, ref = CounterRegistry(), JaxCounterRegistry()
    for r in (reg, ref):
        _produce(r, 0, 40)
        _produce(r, 5, 40, base=3)
    lanes = reg.snapshot_lanes()
    enc = json.loads(json.dumps(telemetry.encode_lanes(lanes)))
    assert enc == json.loads(json.dumps(
        jax_telemetry.encode_lanes(ref.snapshot_lanes())))
    back = telemetry.decode_lanes(enc)
    assert lane_events(back, t_ns=0) == lane_events(lanes, t_ns=0)


@pytest.mark.parametrize("frame", [
    {"t": "nope"},
    {"t": FRAME_HEADER, "format": "other", "v": 1},
    {"t": FRAME_DELTA, "q": 1}],
    ids=["kind", "format", "delta"])
def test_malformed_frame_is_refused_as_the_reference(frame):
    with pytest.raises(TelemetryFrameError) as got:
        telemetry.validate_frame(frame)
    with pytest.raises(jax_telemetry.TelemetryFrameError) as want:
        jax_telemetry.validate_frame(frame)
    assert str(got.value) == str(want.value)


def _bridge_frames(pkg, run_scenario, name, mode, fault):
    bridge = pkg.TelemetryBridge(period_s=60, session="parity")
    run = run_scenario(name, engine_mode=mode, size="smoke", seed=0,
                       telemetry=bridge, fault=fault)
    bridge.stop()
    bridge.close()
    frames = [_timeless(f) for f in bridge.ring.frames()
              if f["t"] != FRAME_FINDING]
    # a finding's severity (and so the order findings fire in) weighs
    # measured search times; what it found, where, is deterministic
    found = sorted((f["src"], f["kind"], f["pid"], f["message"])
                   for f in bridge.findings_json())
    return frames, found, (bridge.polls, bridge.deltas_total), \
        run.finding_kinds


@pytest.mark.parametrize("name,mode,fault", [
    ("unexpected_storm", "leaky_umq", None),
    ("master_worker", "linear", None),
    ("halo3d", "fifo", "drop"),
    ("amg_coarsen", "fifo", "rank_leave")])
def test_bridge_frames_are_the_reference(name, mode, fault):
    got = _bridge_frames(telemetry, workloads.run_scenario, name, mode, fault)
    want = _bridge_frames(jax_telemetry, jax_workloads.run_scenario, name,
                          mode, fault)
    assert got == want
    frames = got[0]
    assert frames[0]["t"] == FRAME_HEADER and frames[-1]["t"] == FRAME_END
    assert sum(f["m"]["nd"] for f in frames if f["t"] == FRAME_DELTA) \
        == got[2][1] > 0


def test_bridge_keeps_every_delta_under_concurrent_producers():
    reg = CounterRegistry()
    with TelemetryBridge(period_s=0.002) as bridge:
        src = bridge.watch(reg)
        threads = [threading.Thread(target=_produce, args=(reg, p, 2000))
                   for p in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        lanes = bridge.unwatch(src)
    assert sum(per["match.posted"].count for per in lanes.values()) == 6000
    assert bridge.deltas_total == reg.drain_stats()["deltas_merged"] == 12000


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read())


def test_http_endpoints_answer():
    reg = CounterRegistry()
    bridge = TelemetryBridge(period_s=60, session="httptest")
    bridge.watch(reg, name="r")
    _produce(reg, 2, 64)
    bridge.poll()
    with TelemetryServer(bridge) as srv:
        m = _get(srv.url + "/metrics")
        assert m["session"] == "httptest" and m["drain"]["r"]["pending"] == 0
        lanes = telemetry.decode_lanes(m["sources"]["r"])
        assert lanes[2]["match.posted"].count == 64
        assert isinstance(_get(srv.url + "/findings"), list)
        assert _get(srv.url + "/")["endpoints"] == ["/metrics", "/findings",
                                                     "/stream"]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(srv.url + "/nope", timeout=5)
        assert err.value.code == 404
        frames = []
        with urllib.request.urlopen(srv.url + "/stream", timeout=5) as r:
            buf = b""
            while len(frames) < 2:
                chunk = r.read(1)
                if not chunk:
                    break
                buf += chunk
                if buf.endswith(b"\n\n"):
                    if buf.startswith(b"data: "):
                        frames.append(json.loads(buf[6:]))
                    buf = b""
    assert [telemetry.validate_frame(f) for f in frames] == [FRAME_HEADER,
                                                             FRAME_DELTA]
    assert telemetry.frame_lanes(frames[1])[2]["match.posted"].count == 64


def test_serve_with_telemetry_serves_the_same_tokens():
    reset_global_registry()
    try:
        plain, plain_stats = serve.main(SERVE_ARGS)
        assert "telemetry" not in plain_stats
        # counters that a host-side exchange left pending in the global
        # registry: the bridge's first poll adopts them
        sc = workloads.get("unexpected_storm")
        fab = workloads.build_fabric(sc, "leaky_umq",
                                     registry=global_registry())
        sc.drive(fab, random.Random(0), sc.params("smoke"))
        gen, stats = serve.main(SERVE_ARGS + ["--telemetry"])
        tel = stats["telemetry"]
        drain = global_registry().drain_stats()
    finally:
        reset_global_registry()
    assert torch.equal(gen, plain)
    assert torch.equal(stats["prefill_logits"], plain_stats["prefill_logits"])
    assert tel["url"].startswith("http://127.0.0.1:")
    assert tel["polls"] >= 1
    assert tel["deltas_total"] == drain["deltas_merged"] > 0
    assert drain["pending"] == 0
    assert "umq_flood" in {f["kind"] for f in tel["findings"]}
    names = [e.name for e in global_collector().drain()]
    assert names.count("serve/prefill") == 1
    assert names.count("serve/decode_step") == 3
