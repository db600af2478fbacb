"""The dry run of llama-3.2-vision-11b (gated cross-attention over encoder
embeddings) and musicgen-large (frames, 4 codebooks) against the
reference's (smoke, the (2,4) mesh, train at B 4, T 64 and decode at B 4
with a cache of 64), as ``tests/test_torch_dryrun_jax.py`` holds yi-6b and
deepseek-moe-16b: in a module of its own, so that its JAX compile runs
beside the others.

* Argument bytes equal the reference's exactly (decode adding the f32 the
  port's serving weights keep, ``f32_scales``). Both sides count only the
  arguments the step reads: ``jax.jit`` drops unused ones, and a vlm's
  decode reads the cached encoder keys and values, not the
  cross-attention's ``wk`` and ``wv``.
* FLOPs lie within 15% (0.91 and 1.00 for the vlm's train and decode,
  1.14 and 1.00 for musicgen's when this test was written). musicgen's
  train cell reads the highest: its one layer makes the chunked loss's
  lm-head product, which the port recomputes in the backward (the
  boundary that ``tests/test_torch_dryrun_jax.py`` names), the larger
  share of the cell.
* Wire bytes a device lie in [0.25, 1.5] of the reference's (0.38, 0.39,
  1.14 and 0.58 when this test was written).
* The vlm's decode attends the cross-attention cache where it lies, its
  N slots split over ``"model"``: no collective moves a block of it, or
  all of it.
* The vlm's training reaches the flash kernels' fake branch at the cross
  shape: non-causal calls at T 64 against N 32.
"""
import json

import pytest

from repro_torch.configs import archs as torch_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import hlo
from repro_torch.launch import dryrun
from test_torch_dryrun_jax import (check_argument_bytes, check_flops,
                                   check_wire_bytes, jax_script, port_cells)

VLM = "llama-3.2-vision-11b"
ARCHS = (VLM, "musicgen-large")
CELLS = [f"{a}/{k}" for a in ARCHS for k in ("train", "decode")]


@pytest.fixture(scope="module")
def subproc():
    from conftest import run_in_subprocess
    return run_in_subprocess


@pytest.fixture(scope="module")
def jax_cells(subproc):
    return json.loads(subproc(jax_script(ARCHS), devices=8).split("JSON")[1])


@pytest.fixture(scope="module")
def port():
    return port_cells(ARCHS)


@pytest.mark.parametrize("key", CELLS)
def test_argument_bytes_are_the_references(jax_cells, port, key):
    check_argument_bytes(jax_cells, port, key)


@pytest.mark.parametrize("key", CELLS)
def test_flops_are_within_15_percent_of_the_references(jax_cells, port, key):
    check_flops(jax_cells, port, key)


@pytest.mark.parametrize("key", CELLS)
def test_wire_bytes_lie_in_the_band_of_the_references(jax_cells, port, key):
    check_wire_bytes(jax_cells, port, key)


def test_vlm_training_reaches_the_fake_branch_at_the_cross_shape(port):
    """5 self-attention layers and one cross sublayer, full remat: the
    cross-attention's calls are non-causal."""
    assert port[f"{VLM}/train"]["flash_launches_by_shape"] == {
        "fwd/16/causal": 10, "dq/16/causal": 5, "dkv/16/causal": 5,
        "fwd/16/non-causal": 2, "dq/16/non-causal": 1,
        "dkv/16/non-causal": 1}


def test_vlm_decode_never_moves_the_cross_cache(monkeypatch):
    """The (2,4) decode cell recorded op by op: the cross cache (B 4, N 32,
    K 4, D 16) lies in blocks of (2, 8, 4, 16), and no collective has a
    block, or the whole cache, among its operands or results; the decode
    attends it (local ops read the blocks)."""
    recorders = []

    class Kept(hlo.Recorder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            recorders.append(self)

    monkeypatch.setattr(dryrun.hlo, "Recorder", Kept)
    cfg = torch_archs.get_config(VLM, "smoke")
    r = dryrun.run_cell(VLM, "decode", mesh_shape=(2, 4), device="cpu",
                        cfg=cfg, shape=ShapeConfig("t", 64, 4, "decode"),
                        save=False, verbose=False)
    assert r["ok"]
    K, D = cfg.n_kv_heads, cfg.head_dim
    cross = {(2, 8, K, D), (4, 32, K, D), (2, 32, K, D), (4, 8, K, D)}
    ops = recorders[0].recording.ops
    moved = [op for op in ops if op.kind == "collective"
             and any(shape in cross for _dt, shape in
                     op.operands + op.results)]
    assert not moved, [op.line for op in moved]
    assert any(op.kind == "op" and ("bf16", (2, 8, K, D)) in op.operands
               for op in ops)
