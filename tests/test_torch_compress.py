"""int8 error-feedback compression (``repro_torch.optim.compress``)
against the JAX package's ``repro.optim.compress``.

``compress`` and ``decompress`` give the same bits as the reference's
compiled ones on random inputs (both round half to even, in f32; under
``jit`` XLA divides by 127 as a product with f32(1/127) and rounds the
residual ``y - q*scale`` once, as a fused multiply-add; they differ on
f32 subnormals, which XLA's CPU code flushes to zero); error feedback
contracts
(the reference's own property, ``tests/test_optim_data.py``); and
``compressed_psum`` over 4 gloo ranks, rendezvousing through a
``FileStore``, equals the reference's under ``shard_map`` over 4 forced
host devices, bit for bit.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import compress as jax_compress
from repro_torch.optim import compress
from torch_rank_workers import compressed_psum_rank, run_ranks


def bits(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == np.float32 \
        else np.asarray(x)


def normal(v):
    """``v`` with magnitudes below 2^-100 flushed to 0: far from the f32
    subnormals, which XLA's CPU code flushes to zero and torch keeps
    (:func:`test_subnormals_are_kept_where_compiled_jax_flushes_them`)."""
    return 0.0 if abs(v) < 2.0 ** -100 else v


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=-100, max_value=100,
                          allow_nan=False).map(normal),
                min_size=1, max_size=64),
       st.lists(st.floats(min_value=-1, max_value=1,
                          allow_nan=False).map(normal),
                min_size=64, max_size=64))
def test_compress_is_the_references_bit_for_bit(values, errs):
    x = np.asarray(values, np.float32)
    e = np.asarray(errs[:len(values)], np.float32)
    q, scale, err = compress.compress(torch.from_numpy(x), torch.from_numpy(e))
    jq, jscale, jerr = jax.jit(jax_compress.compress)(jnp.asarray(x),
                                                      jnp.asarray(e))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bits(scale.numpy()), bits(jscale))
    np.testing.assert_array_equal(bits(err.numpy()), bits(jerr))
    np.testing.assert_array_equal(
        bits(compress.decompress(q, scale).numpy()),
        bits(jax_compress.decompress(jq, jscale)))


def test_the_compiled_reference_is_held_not_the_op_by_op_one():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    e = np.zeros_like(x)
    _q, _s, err = compress.compress(torch.from_numpy(x), torch.from_numpy(e))
    _jq, _js, eager = jax_compress.compress(jnp.asarray(x), jnp.asarray(e))
    _jq, _js, fused = jax.jit(jax_compress.compress)(jnp.asarray(x),
                                                     jnp.asarray(e))
    np.testing.assert_array_equal(bits(err.numpy()), bits(fused))
    assert not np.array_equal(bits(eager), bits(fused))


def test_subnormals_are_kept_where_compiled_jax_flushes_them():
    x = np.zeros(2, np.float32)
    e = np.array([0.0, 2.0 ** -140], np.float32)          # an f32 subnormal
    _q, _s, err = compress.compress(torch.from_numpy(x), torch.from_numpy(e))
    _jq, _js, jerr = jax.jit(jax_compress.compress)(jnp.asarray(x),
                                                    jnp.asarray(e))
    assert err[1] == 2.0 ** -140 and float(np.asarray(jerr)[1]) == 0.0


def test_round_half_to_even_as_jax():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5])
    assert torch.round(x).tolist() == np.asarray(
        jnp.round(jnp.asarray(x.numpy()))).tolist() == [0, 2, 2, 0, -2, 126]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=-100, max_value=100, allow_nan=False),
                min_size=1, max_size=32))
def test_compression_error_feedback_contracts(values):
    """The carried error is bounded by half a quantization step, so the
    accumulated updates stay unbiased."""
    x = torch.tensor(values, dtype=torch.float32)
    q, scale, err = compress.compress(x, torch.zeros_like(x))
    deq = compress.decompress(q, scale)
    assert torch.allclose(deq + err, x, atol=1e-4)
    assert float(err.abs().max()) <= float(scale) / 2 + 1e-6


def test_init_error_is_zero_f32_like_the_tree():
    params = {"a": torch.ones(3, 2, dtype=torch.bfloat16),
              "b": {"c": torch.ones(4)}}
    err = compress.init_error(params)
    assert err["a"].shape == (3, 2) and err["a"].dtype == torch.float32
    assert err["b"]["c"].shape == (4,) and not err["b"]["c"].any()


WORLD = 4


def rank_inputs():
    rng = np.random.default_rng(7)
    grads = [{"w": (rng.standard_normal(37) * 10 ** r).astype(np.float32),
              "m": rng.standard_normal((5, 6)).astype(np.float32)}
             for r in range(WORLD)]
    errors = [{k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
               for k, v in g.items()} for g in grads]
    return grads, errors


JAX_PSUM = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core.compat import make_mesh, shard_map
    from repro.optim import compress
    inp, out = sys.argv[1], sys.argv[2]
    d = np.load(inp)
    g = {k[2:]: d[k] for k in d.files if k.startswith("g_")}
    e = {k[2:]: d[k] for k in d.files if k.startswith("e_")}

    def f(g, e):
        g, e = (jax.tree.map(lambda x: x[0], t) for t in (g, e))
        r, ne = compress.compressed_psum(g, e, "d")
        return tuple(jax.tree.map(lambda x: x[None], t) for t in (r, ne))

    mesh = make_mesh((4,), ("d",))
    spec = P("d")
    r, ne = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec, spec),
                              out_specs=(spec, spec)))(g, e)
    np.savez(out, **{"r_" + k: np.asarray(v) for k, v in r.items()},
             **{"e_" + k: np.asarray(v) for k, v in ne.items()})
    print("PSUM OK")
""")


def test_compressed_psum_on_4_ranks_is_the_references(tmp_path, subproc):
    grads, errors = rank_inputs()
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **{f"g_{k}": np.stack([g[k] for g in grads]) for k in grads[0]},
             **{f"e_{k}": np.stack([e[k] for e in errors]) for k in grads[0]})
    script = tmp_path / "jax_psum.py"
    script.write_text(JAX_PSUM)
    assert "PSUM OK" in subproc(
        f"import runpy, sys; sys.argv = ['x', {str(inp)!r}, {str(out)!r}]; "
        f"runpy.run_path({str(script)!r}, run_name='__main__')", devices=WORLD)
    want = np.load(out)
    got = run_ranks(compressed_psum_rank, WORLD, grads, errors,
                    store_dir=str(tmp_path / "store"), timeout=120)
    for r, (red, err) in enumerate(got):
        for k in grads[0]:
            np.testing.assert_array_equal(bits(red[k]), bits(want[f"r_{k}"][r]))
            np.testing.assert_array_equal(bits(err[k]), bits(want[f"e_{k}"][r]))
    # every rank holds the same reduced gradients
    for k in grads[0]:
        assert all(np.array_equal(got[0][0][k], g[0][k]) for g in got)
