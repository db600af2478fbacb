"""xlstm-125m's dry run against the reference's (smoke, the (2,4) mesh,
train at B 4, T 64 and decode at B 4 with a cache of 64), as
``tests/test_torch_dryrun_jax.py`` holds yi-6b and deepseek-moe-16b: in a
module of its own, so that its JAX compile runs beside the others. No
kernel lies on the xLSTM path: the dry run records plain ops only.

* Argument bytes equal the reference's exactly (decode adding the f32 the
  port's serving weights keep, ``f32_scales``); an xLSTM decode reads no
  position, and neither side counts it (``jax.jit`` drops unused
  arguments).
* FLOPs lie within 15% (1.00 and 1.00 when this test was written). The
  reference's walker counts dot FLOPs and each while loop's body times
  its trip count; the port records every op it runs, the sLSTM loop's T
  steps one by one, and counts the same products. Decode steps the cells
  on each rank's heads where the heads' axes divide them, as the
  reference's partitioner splits them at this mesh (4 heads over a model
  axis of 4); with the heads replicated the cell read 1.48.
* Wire bytes a device lie in [0.25, 1.5] of the reference's (0.59 and 1.14
  when this test was written).
"""
import json

import pytest

from test_torch_dryrun_jax import (check_argument_bytes, check_flops,
                                   check_wire_bytes, jax_script, port_cells)

ARCHS = ("xlstm-125m",)
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


def test_no_kernel_runs_on_the_xlstm_path(port):
    for key in CELLS:
        assert port[key]["flash_launches_by_shape"] == {}
        assert port[key]["scan_fake_launches"] == {"fwd": 0, "bwd": 0}
