"""jamba-v0.1-52b's dry run against the reference's (smoke, the (2,4)
mesh, train at B 4, T 64 and decode at B 4 with a cache of 64), as
``tests/test_torch_dryrun_jax.py`` holds yi-6b and deepseek-moe-16b: in a
module of its own, so that its JAX compile, the longest of the three
archs', runs beside the rest.

* Argument bytes equal the reference's exactly (decode adding the f32 the
  port's serving weights keep: the norms, and the SSM's ``dt_w``, ``dt_b``
  and ``conv_b``, which the reference's specs give in bf16).
* FLOPs lie within 15% (1.13 and 1.04 of the reference's when this test
  was written). The reference's walker counts dot FLOPs only, so it counts
  none of the selective scan's elementwise work, which its jnp scan does
  outside any dot; the port counts the scan kernels' work
  (``cost.scan_work``: 6 FLOPs a (b, t, channel, state) and 3 a (b, t,
  channel); ``cost.scan_bwd_work``: 22 and 6), about 4% of the cell at
  the smoke preset's d_state of 4. The port's own boundaries of the other
  kernels are those of ``tests/test_torch_dryrun_jax.py``.
* Wire bytes a device lie in [0.25, 1.5] of the reference's (0.478 and
  0.431 when this test was written); each assertion prints both sides'
  collectives by opcode.
"""
import json

import pytest

from test_torch_dryrun_jax import (check_all_to_all, check_argument_bytes,
                                   check_flops, check_wire_bytes, jax_script,
                                   port_cells)

ARCHS = ("jamba-v0.1-52b",)
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


def test_moe_decode_records_an_all_to_all_where_the_reference_does(
        jax_cells, port):
    check_all_to_all(jax_cells, port, "jamba-v0.1-52b/decode")
