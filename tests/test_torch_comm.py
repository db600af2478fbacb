"""The port's comm layer against the JAX package's on 8 ranks.

The JAX outputs come from one subprocess with 8 forced host devices (the
reference's own ``shard_map`` over a mesh), saved as numpy arrays; the
port runs the same inputs on its single-controller mesh
(``repro_torch.comm.mesh``: stacked blocks on one device) on the CPU.
Outputs are held within 1e-5 relative (``tests/test_comm.py``'s bound for
the halo app; the port sums in the same order but in other kernels).
Routing through the matching fabric must count the reference's 168
operations, and the step-level region paths of the halo app must be the
reference's. The progress-engine and backend tests repeat
``tests/test_comm.py``'s on the port.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.comm import collectives, patterns, ring
from repro_torch.comm.backends import BACKENDS, get_backend, maybe_fence
from repro_torch.comm.halo import (HaloProgram, make_halo_fn,
                                   make_xla_auto_fn)
from repro_torch.comm.mesh import Mesh, axis_index, axis_size, shard_map
from repro_torch.comm.progress import ProgressEngine
from repro_torch.core import analyses
from repro_torch.core.collector import global_collector, reset_global_collector
from repro_torch.core.counters import CounterRegistry
from repro_torch.core.graphframe import GraphFrame
from repro_torch.launch import halo as halo_app
from repro_torch.match import Fabric

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SEED = 0
HALO_STEPS = 3

# the reference run: writes every output the tests compare into an npz
JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.comm import collectives, ring
    from repro.comm.halo import HaloProgram, make_halo_fn, make_xla_auto_fn
    from repro.core import regions
    from repro.core.collector import reset_global_collector
    from repro.core.compat import make_mesh, shard_map
    from repro.core.counters import CounterRegistry
    from repro.match import Fabric

    out_path, seed, steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8 * 16, 4)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    u = rng.standard_normal((8, 8, 8)).astype(np.float32)
    res = {"x": x, "w": w, "u": u}

    mesh = make_mesh((8,), ("r",))
    def sm(f, ins=P("r", None), outs=P("r", None)):
        return jax.jit(shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs))
    for sched in ("serial", "overlap"):
        res["ag_" + sched] = sm(lambda s: ring.ring_all_gather(
            s, "r", schedule=sched))(x)
        res["ar_" + sched] = sm(lambda s: ring.ring_all_reduce(
            s, "r", schedule=sched))(x)
        res["agm_" + sched] = sm(lambda s, w: ring.overlap_matmul_allgather(
            s, w, "r", schedule=sched), (P("r", None), P(None, None)))(x, w)
        res["rsm_" + sched] = sm(lambda s, w: ring.reduce_scatter_matmul(
            s, w, "r", schedule=sched), (P(None, None), P(None, None)))(
            x[:16], w)
    res["psum"] = sm(lambda s: collectives.psum(s, "r"))(x)
    res["all_gather"] = sm(lambda s: collectives.all_gather(s, "r"))(x)
    res["all_gather_stacked"] = sm(lambda s: collectives.all_gather(
        s, "r", axis=1, tiled=False))(x)
    res["reduce_scatter"] = sm(lambda s: collectives.reduce_scatter(s, "r"))(
        x)
    res["all_to_all"] = sm(lambda s: collectives.all_to_all(s, "r", 0, 1))(x)
    res["ppermute"] = sm(lambda s: collectives.ppermute(
        s, "r", [(0, 3), (3, 5), (5, 0), (1, 2)]))(x)
    res["axis_index"] = sm(lambda s: s * 0 + jax.lax.axis_index("r"))(x)

    # 168 routed ops: tests/test_match.py's comm-layer workload
    reg = CounterRegistry()
    collectives.configure_matching(Fabric(mode="binned", registry=reg))
    xr = jnp.arange(8 * 4, dtype=jnp.float32).reshape(8, 4)
    sm(lambda s: ring.ring_all_gather(s, "r"))(xr)
    sm(lambda s: collectives.psum(s, "r"), outs=P(None, None))(xr)
    collectives.configure_matching(None)
    stats = reg.drain()
    counters = {k: [s.kind, s.count, s.total, s.vmin, s.vmax]
                for k, s in stats.items() if not k.endswith("_ns")}

    mesh3 = make_mesh((2, 2, 2), ("x", "y", "z"))
    ug = jax.device_put(jnp.asarray(u), NamedSharding(mesh3, P("x", "y", "z")))
    paths = {}
    for name, explicit in (("explicit", True), ("vendor", False)):
        prog = HaloProgram(mesh3, explicit=explicit)
        prog.run(ug, steps=steps)                   # compile
        col = reset_global_collector()
        res["halo_" + name] = prog.run(ug, steps=steps)
        paths[name] = sorted({"/".join(e.path) for e in col.drain()
                              if len(e.path) <= 3})
    for variant in ("blocking", "overlap"):
        res["halo_fn_" + variant] = jax.jit(make_halo_fn(
            mesh3, variant=variant, steps=steps))(ug)
    res["xla_auto"] = jax.jit(make_xla_auto_fn(mesh3, steps=steps))(ug)
    np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})
    print(json.dumps({"counters": counters, "paths": paths}))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs (npz arrays) and its fabric counters and
    halo region paths (JSON), from one 8-device subprocess."""
    path = str(tmp_path_factory.mktemp("jax_comm") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, path, str(SEED), str(HALO_STEPS)],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    arrays = dict(np.load(path))
    return arrays, json.loads(out.stdout.strip().splitlines()[-1])


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    want = torch.from_numpy(np.asarray(want, dtype=np.float32))
    assert tuple(got.shape) == tuple(want.shape)
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


RING = Mesh((8,), ("r",))


def _ring_out(fn, *args):
    """Run ``fn`` on the 8-rank ring mesh; global result (out_specs
    P("r", None): each rank's block stacked along rows)."""
    return RING.unshard(shard_map(fn, mesh=RING)(*args))


@pytest.mark.parametrize("schedule", ["serial", "overlap"])
@pytest.mark.parametrize("name", ["ag", "ar", "agm", "rsm"])
def test_ring_collectives_match_the_reference(ref, name, schedule):
    arrays, _ = ref
    x, w = torch.from_numpy(arrays["x"]), torch.from_numpy(arrays["w"])
    xs, ws = RING.shard(x), RING.replicate(w)
    if name == "ag":
        got = _ring_out(lambda s: ring.ring_all_gather(
            s, "r", schedule=schedule), xs)
    elif name == "ar":
        got = _ring_out(lambda s: ring.ring_all_reduce(
            s, "r", schedule=schedule), xs)
    elif name == "agm":
        got = _ring_out(lambda s, w: ring.overlap_matmul_allgather(
            s, w, "r", schedule=schedule), xs, ws)
    else:
        got = _ring_out(lambda s, w: ring.reduce_scatter_matmul(
            s, w, "r", schedule=schedule), RING.replicate(x[:16]), ws)
    assert _rel(got, arrays[f"{name}_{schedule}"]) < TOL


@pytest.mark.parametrize("name", ["psum", "all_gather", "all_gather_stacked",
                                  "reduce_scatter", "all_to_all", "ppermute",
                                  "axis_index"])
def test_collectives_match_jax_lax(ref, name):
    arrays, _ = ref
    xs = RING.shard(torch.from_numpy(arrays["x"]))
    fn = {
        "psum": lambda s: collectives.psum(s, "r"),
        "all_gather": lambda s: collectives.all_gather(s, "r"),
        "all_gather_stacked": lambda s: collectives.all_gather(
            s, "r", axis=1, tiled=False),
        "reduce_scatter": lambda s: collectives.reduce_scatter(s, "r"),
        "all_to_all": lambda s: collectives.all_to_all(s, "r", 0, 1),
        "ppermute": lambda s: collectives.ppermute(
            s, "r", [(0, 3), (3, 5), (5, 0), (1, 2)]),
        "axis_index": lambda s: s * 0 + axis_index("r").view(8, 1, 1),
    }[name]
    assert _rel(_ring_out(fn, xs), arrays[name]) < TOL


def test_collective_regions_carry_block_bytes():
    xs = RING.shard(torch.zeros(8 * 16, 4))
    col = reset_global_collector()
    shard_map(lambda s: collectives.ppermute(
        collectives.psum(s, "r"), "r", patterns.ring_perm(8)), mesh=RING)(xs)
    evs = {e.name: e for e in col.drain()}
    for name in ("psum(r)", "ppermute(r)"):
        assert evs[name].category == "collective"
        assert evs[name].attrs["bytes"] == 16 * 4 * 4   # one rank's block


def test_comm_layer_routes_through_fabric(ref):
    """tests/test_match.py's workload on the port: 168 routed ops, PRQ
    traversal depth at most 4, and every non-time counter as the
    reference's."""
    _, meta = ref
    reg = CounterRegistry()
    collectives.configure_matching(Fabric(mode="binned", registry=reg))
    try:
        x = RING.shard(torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4))
        shard_map(lambda s: ring.ring_all_gather(s, "r"), mesh=RING)(x)
        shard_map(lambda s: collectives.psum(s, "r"), mesh=RING)(x)
    finally:
        collectives.configure_matching(None)
    stats = reg.drain()
    total = stats["match.expected"].total + stats["match.unexpected"].total
    assert total == 7 * 8 + 14 * 8 == 168
    assert stats["match.prq.traversal_depth"].vmax <= 4
    mine = {k: [s.kind, s.count, s.total, s.vmin, s.vmax]
            for k, s in stats.items() if not k.endswith("_ns")}
    assert mine == meta["counters"]


HALO_MESH = Mesh((2, 2, 2), ("x", "y", "z"))


@pytest.mark.parametrize("name", ["explicit", "vendor"])
def test_halo_program_matches_the_reference(ref, name):
    arrays, meta = ref
    u = HALO_MESH.shard(torch.from_numpy(arrays["u"]))
    prog = HaloProgram(HALO_MESH, explicit=name == "explicit")
    col = reset_global_collector()
    out = prog.run(u, steps=HALO_STEPS)
    assert _rel(HALO_MESH.unshard(out), arrays[f"halo_{name}"]) < TOL
    # the reference's step-level regions fire on every call (the
    # segments' inner regions fire once per compile there)
    paths = sorted({"/".join(e.path) for e in col.drain()
                    if len(e.path) <= 3})
    assert paths == meta["paths"][name]


@pytest.mark.parametrize("variant", ["blocking", "overlap"])
def test_halo_fn_matches_the_reference(ref, variant):
    arrays, _ = ref
    u = HALO_MESH.shard(torch.from_numpy(arrays["u"]))
    out = make_halo_fn(HALO_MESH, variant=variant, steps=HALO_STEPS)(u)
    assert _rel(HALO_MESH.unshard(out), arrays[f"halo_fn_{variant}"]) < TOL


def test_vendor_fn_matches_the_reference(ref):
    arrays, _ = ref
    u = HALO_MESH.shard(torch.from_numpy(arrays["u"]))
    out = make_xla_auto_fn(HALO_MESH, steps=HALO_STEPS)(u)
    assert _rel(HALO_MESH.unshard(out), arrays["xla_auto"]) < TOL


@pytest.mark.parametrize("dims", [(2, 2, 2), (2, 2, 1), (4, 1, 2)])
def test_mesh_shard_unshard_round_trip(dims):
    mesh = Mesh(dims, ("x", "y", "z"))
    g = torch.arange(8 * 6 * 4 * 3, dtype=torch.float32).reshape(8, 6, 4, 3)
    s = mesh.shard(g)
    assert tuple(s.shape) == (*dims, 8 // dims[0], 6 // dims[1],
                              4 // dims[2], 3)
    # block (i, j, k) is rank (i, j, k)'s shard
    assert torch.equal(s[1, 0, 0], g[8 // dims[0]:2 * (8 // dims[0]),
                                     :6 // dims[1], :4 // dims[2]])
    assert torch.equal(mesh.unshard(s), g)
    with mesh.active():
        assert [axis_size(a) for a in ("x", "y", "z")] == list(dims)
        assert torch.equal(axis_index("y")[:, :, 0],
                           torch.arange(dims[1]).expand(dims[0], dims[1]))


def test_collectives_need_an_active_mesh():
    with pytest.raises(RuntimeError, match="no active mesh"):
        collectives.psum(torch.zeros(8, 2), "r")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_halo_app_runs_each_backend(backend):
    payload = halo_app.main(["--device", "cpu", "--backend", backend,
                             "--box", "8", "--steps", "2", "--runs", "2",
                             "--seed", "3"])
    assert payload["backend"] == backend and payload["devices"] == 8
    assert len(payload["frames"]) == len(payload["walls"]) == 2
    tree = GraphFrame.from_dict(payload["frames"][0])
    for path in (("cycle_0", "bench_comm", "pre-comm"),
                 ("cycle_1", "bench_comm", "post-recv"), ("wait-send",),
                 ("add_vars",)):
        assert tree.node(path) is not None, path
    counters = payload["counters"]
    if get_backend(backend).kind == "auto":
        assert counters == {}
    else:
        # 2 steps x 6 faces x 2 ranks a ring of 2
        ops = (counters["match.expected"]["total"]
               + counters["match.unexpected"]["total"])
        assert ops == 2 * 6 * 2


def test_halo_app_backends_agree_and_write_a_trace(tmp_path):
    sums, outs = {}, {}
    for backend in sorted(BACKENDS):
        payload, out = halo_app.run(backend, box=8, steps=2, runs=1,
                                    device="cpu", seed=5,
                                    trace_out=str(tmp_path / f"{backend}.json"))
        sums[backend], outs[backend] = payload["checksum"], out
        assert os.path.exists(payload["trace"])
    ref_out = outs["xla_auto"]
    for backend, out in outs.items():
        assert float((out - ref_out).abs().max()
                     / ref_out.abs().max()) < TOL, backend
        assert abs(sums[backend] - sums["xla_auto"]) <= TOL * sums["xla_auto"]


def test_halo_app_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        halo_app.main(["--box", "8", "--runs", "1"])


# ------------------------------------------------------- progress engine

@pytest.mark.parametrize("mode", ["shared", "incoming"])
def test_progress_engine_correctness(mode):
    x = torch.arange(8.0)
    eng = ProgressEngine(mode)
    reqs = [eng.submit(lambda t: t * 2, x + i) for i in range(16)]
    for i, r in enumerate(reqs):
        assert torch.equal(r.wait(), (x + i) * 2)
    eng.shutdown()


def test_progress_engine_error_propagation():
    def boom(_):
        raise ValueError("boom")

    eng = ProgressEngine("incoming")
    req = eng.submit(boom, 1)
    try:
        with pytest.raises(ValueError):
            req.wait(timeout=10)
    finally:
        eng.shutdown()


def test_progress_engine_lifecycle():
    eng = ProgressEngine("incoming", process_fn=lambda r: None,
                         autostart=False)
    assert not eng.running
    with pytest.raises(RuntimeError):
        eng.submit(lambda: 1)            # not started yet
    eng.start()
    eng.start()                          # idempotent while running
    assert eng.running
    assert eng.submit(lambda: 41 + 1).wait(timeout=10) == 42
    eng.shutdown()
    eng.shutdown()                       # idempotent when stopped
    assert not eng.running
    with pytest.raises(RuntimeError):
        eng.submit(lambda: 1)            # stopped engines refuse work
    eng.start()                          # restart reuses the engine
    assert eng.submit(lambda: "again").wait(timeout=10) == "again"
    eng.shutdown()


def test_progress_engine_process_fn_and_labels():
    done = []
    gate = threading.Event()
    eng = ProgressEngine("incoming", process_fn=done.append)
    try:
        assert eng.submit(lambda: 7, label="seven").wait(timeout=10) == 7
        assert done == [7]
        req = eng.submit(gate.wait, 10, label="stalled-op")
        with pytest.raises(TimeoutError, match="stalled-op"):
            req.wait(timeout=0.05)
    finally:
        gate.set()
        eng.shutdown()


def test_shared_queue_contends_incoming_does_not():
    """The paper's §4 finding as an assertion: cross-thread lock-region
    contention exists with one queue and vanishes with the second."""
    x = torch.ones((512, 512))

    def work(t):
        return (t @ t).sum()

    work(x)

    def run(mode):
        reset_global_collector()
        eng = ProgressEngine(mode)
        reqs = []
        for i in range(32):
            reqs.append(eng.submit(work, x))
            if i % 4 == 3:
                time.sleep(0.001)
        for r in reqs:
            r.wait()
        eng.shutdown()
        evs = global_collector().drain()
        cont = analyses.contention(evs, name_filter="BlockingProgress")
        isend = [e.duration for e in evs if e.name == "MPI_Isend"]
        return cont, max(isend)

    cont_shared, max_isend_shared = run("shared")
    cont_inc, max_isend_inc = run("incoming")
    assert sum(f.severity for f in cont_shared) > sum(
        f.severity for f in cont_inc)
    assert max_isend_shared > max_isend_inc


def test_backends_registry():
    assert set(BACKENDS) >= {"xla_auto", "explicit_serial",
                             "explicit_overlap", "explicit_serial_oversub"}
    assert get_backend("explicit_serial_oversub").fence_every_op
    t = torch.zeros(3)
    assert maybe_fence(get_backend("explicit_serial_oversub"), t)[0] is t
