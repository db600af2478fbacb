"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX package's.

With no processes behind them: the rules, ``_fit_entry`` and ``pspec``
take a mesh stand-in that has only ``.shape`` (a mapping of axis sizes,
as ``tests/test_sharding_dryrun.py``'s ``FakeMesh``). A port placement
tuple is the translation of a JAX ``PartitionSpec``: ``Shard(i)`` on every
mesh axis that entry ``i`` names, ``Replicate()`` on the rest. The JAX
parameters are stacked over a leading ``layers`` axis (always replicated);
the port's are one per layer.
"""
import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import archs as jax_archs
from repro.configs.base import SHAPES
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch.configs import archs as torch_archs
from repro_torch.models import model as TM
from repro_torch.sharding import rules as R


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def translate(spec, mesh):
    """The placements of JAX ``PartitionSpec`` ``spec`` on ``mesh``."""
    names = list(mesh.shape)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for n in JR._flatten_entry(entry):
            out[names.index(n)] = Shard(i)
    return tuple(out)


MESHES = [{"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"data": 1, "model": 1}]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m.values())))
def test_make_rules_is_the_references(mesh, shape):
    m = FakeMesh(mesh)
    assert R.make_rules(m, SHAPES[shape]) == JR.make_rules(m, SHAPES[shape])
    assert R.make_rules(m) == JR.make_rules(m)


def test_make_rules_decode_vs_train():
    m = FakeMesh({"data": 16, "model": 16})
    assert R.make_rules(m, SHAPES["train_4k"])["act_seq"] == "model"
    long_rules = R.make_rules(m, SHAPES["long_500k"])
    assert long_rules["batch"] is None
    assert long_rules["seq_kv"] == ("data", "model")
    assert R.make_rules(m, SHAPES["decode_32k"])["act_seq"] is None


FIT_CASES = [(4096, "model"), (4095, "model"), (64, ("pod", "data", "model")),
             (512, ("pod", "data", "model")), (3, ("pod", "data")),
             (32, ("pod", "data")), (16, None), (48, ("data",))]


@pytest.mark.parametrize("dim,entry", FIT_CASES)
def test_fit_entry_is_the_references(dim, entry):
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert R._fit_entry(dim, entry, R.axis_sizes(mesh)) == JR._fit_entry(
        dim, entry, mesh)
    assert R._fit_entry(dim, entry, None) == entry


def test_pspec_divisibility_fitting():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = {"vocab": "model", "batch": ("data",), "embed": "data"}
    assert R.pspec(("vocab", None), rules, shape=(4096, 8), mesh=mesh) == (
        Replicate(), Shard(0))
    assert R.pspec(("vocab", None), rules, shape=(4095, 8), mesh=mesh) == (
        Replicate(), Replicate())


def test_pspec_tuple_axis_partial_drop():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    rules = {"seq_kv": ("pod", "data", "model")}
    # 2*16*16 = 512 does not divide 64; 2*16 = 32 does: Shard(0) on both
    assert R.pspec(("seq_kv",), rules, shape=(64,), mesh=mesh) == (
        Shard(0), Shard(0), Replicate())
    spec = JR.pspec(("seq_kv",), rules, shape=(64,), mesh=mesh)
    assert translate(spec, mesh) == (Shard(0), Shard(0), Replicate())


def test_pspec_refuses_what_a_placement_cannot_say():
    mesh = FakeMesh({"data": 2, "model": 4})
    with pytest.raises(ValueError, match="mesh's order"):
        R.pspec(("x",), {"x": ("model", "data")}, mesh=mesh)
    with pytest.raises(ValueError, match="shards two dimensions"):
        R.pspec(("a", "b"), {"a": "model", "b": "model"}, mesh=mesh)
    with pytest.raises(ValueError, match="mesh="):
        R.pspec(("a",), {"a": "model"})


def jax_param_specs(cfg, mesh, rules):
    """{port parameter name: JAX PartitionSpec of its stacked leaf, the
    leading layers entry dropped}."""
    axes = JM.param_axes(cfg)
    shapes = JM.param_shapes(cfg)
    plen = len(cfg.pattern)
    out = {}

    def walk(a, s, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], s[k], path + (k,))
            return
        spec = JR.pspec(a, rules, shape=s.shape, mesh=mesh)
        if path[0].startswith("pos"):
            assert a[0] == "layers" and (len(spec) == 0 or spec[0] is None)
            i = int(path[0][3:])
            for g in range(cfg.n_groups):
                out[".".join(("layers", str(g * plen + i)) + path[1:])] = (
                    jax.sharding.PartitionSpec(*spec[1:]))
        else:
            out[".".join(path)] = spec

    walk(axes, shapes, ())
    return out


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-v0.1-52b",
                                  "granite-moe-3b-a800m"])
def test_every_parameter_is_placed_as_the_reference(arch):
    mesh = FakeMesh({"data": 2, "model": 4})
    rules = JR.make_rules(mesh)
    want = jax_param_specs(jax_archs.get_config(arch, "smoke"), mesh, rules)
    cfg = torch_archs.get_config(arch, "smoke")
    got = R.tree_shardings(TM.param_axes(cfg), mesh, R.make_rules(mesh),
                           TM.param_shapes(cfg))
    assert sorted(got) == sorted(want)
    model = TM.Model(cfg, torch.device("cpu"))
    assert sorted(got) == sorted(n for n, _ in model.named_parameters())
    for name, spec in want.items():
        assert got[name] == translate(spec, mesh), (name, spec, got[name])
    # something is split over each mesh axis
    assert any(Shard(0) in p[:1] or Shard(1) in p[:1] for p in got.values())
    assert any(p[1] != Replicate() for p in got.values())


def test_tree_shardings_without_shapes_keeps_every_axis():
    mesh = FakeMesh({"data": 2, "model": 4})
    rules = R.make_rules(mesh)
    tree = {"a": ("vocab", None), "b": {"c": ("embed", "mlp")}}
    assert R.tree_shardings(tree, mesh, rules) == {
        "a": (Replicate(), Shard(0)), "b": {"c": (Shard(0), Shard(1))}}


CACHE_CASES = [("yi-6b", "decode_32k"), ("jamba-v0.1-52b", "decode_32k"),
               ("jamba-v0.1-52b", "long_500k"), ("xlstm-125m", "decode_32k"),
               ("gemma3-12b", "decode_32k"),
               ("llama-3.2-vision-11b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CACHE_CASES)
def test_cache_axes_and_placements_are_the_references(arch, shape):
    cfg = jax_archs.get_config(arch, "smoke")
    tree = JM.init_cache_shapes(cfg, 4, 64)
    assert R.cache_axes(tree) == JR.cache_axes(tree)
    mesh = FakeMesh({"data": 2, "model": 4})
    rules = JR.make_rules(mesh, SHAPES[shape])
    got = R.cache_shardings(tree, mesh, R.make_rules(mesh, SHAPES[shape]))
    want = jax.tree.map(lambda a, s: translate(
        JR.pspec(a, rules, shape=s.shape, mesh=mesh), mesh),
        JR.cache_axes(tree), tree, is_leaf=lambda t: isinstance(t, tuple))
    assert got == want


def test_cache_axes_by_name():
    shapes = {"pos0": {"mixer": {
        "k": jax.ShapeDtypeStruct((4, 2, 64, 8, 16), jax.numpy.bfloat16),
        "pos": jax.ShapeDtypeStruct((4, 64), jax.numpy.int32)}}}
    axes = R.cache_axes(shapes)
    assert axes["pos0"]["mixer"]["k"] == (
        "layers", "batch", "seq_kv", "kv_heads", None)
    assert axes["pos0"]["mixer"]["pos"] == ("layers", "seq_kv")


def test_batch_axes_and_placements_are_the_references():
    batch = {"tokens": jax.ShapeDtypeStruct((8, 16), jax.numpy.int32),
             "labels": jax.ShapeDtypeStruct((8, 16, 4), jax.numpy.int32),
             "frames": jax.ShapeDtypeStruct((8, 16, 32), jax.numpy.float32),
             "encoder_embeddings": jax.ShapeDtypeStruct((8, 5, 32),
                                                        jax.numpy.float32),
             "pos": jax.ShapeDtypeStruct((), jax.numpy.int32),
             "mask": jax.ShapeDtypeStruct((8, 16), jax.numpy.bool_)}
    assert R.batch_axes_for(batch) == JR.batch_axes_for(batch)
    for mesh in (FakeMesh({"data": 2, "model": 4}),
                 FakeMesh({"pod": 2, "data": 2, "model": 2})):
        rules = JR.make_rules(mesh)
        want = jax.tree.map(lambda a, s: translate(
            JR.pspec(a, rules, shape=s.shape, mesh=mesh), mesh),
            JR.batch_axes_for(batch), batch,
            is_leaf=lambda t: isinstance(t, tuple))
        assert R.batch_shardings(batch, mesh, R.make_rules(mesh)) == want


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3, requires_grad=True)
    assert R.constrain(x, ("batch", None)) is x
    assert R.grad_constrained(x, ("batch", None)) is x
    assert R.unshard(x) is x
    assert R.current() is None


def test_keep_context_carries_the_context_to_another_thread():
    """A remat's recompute runs on the autograd engine's thread on a card,
    where the contextvar is unset: ``keep_context`` carries it there."""
    import threading

    mesh = FakeMesh({"data": 2, "model": 4})
    rules = R.make_rules(mesh)
    seen = []
    with R.sharding_context(mesh, rules):
        with R.sharding_context(mesh, rules):        # nests
            fn = R.keep_context(lambda: seen.append(R.current()))
        fn()
    t = threading.Thread(target=fn)
    t.start()
    t.join()
    assert seen == [(mesh, rules), (mesh, rules)]
    assert R.current() is None
    assert R.keep_context(len) is len               # no context: as it is
