"""``repro_torch.core`` carries the public names of ``repro.core``.

The port's ``__all__`` is the reference's with ``annotate_torch`` in place
of ``annotate_jax`` (``hlo`` and ``hlo_cost`` read a recorded step where
the reference reads XLA's compiled text). Every name resolves to the
object of its submodule. ``regions``, ``hlo`` and ``hlo_cost`` import
torch, so they load at first use: importing ``repro_torch.core.counters``,
as the host packages do, still imports no torch.
"""
import os
import subprocess
import sys

import pytest

import repro.core as jax_core
import repro_torch.core as core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEFT_OUT = {"annotate_jax"}


def test_all_is_the_references_with_annotate_torch():
    want = (set(jax_core.__all__) - LEFT_OUT) | {"annotate_torch"}
    assert LEFT_OUT <= set(jax_core.__all__)
    assert set(core.__all__) == want
    assert len(core.__all__) == len(set(core.__all__))


@pytest.mark.parametrize("name", sorted(core.__all__))
def test_every_name_is_its_submodules_object(name):
    from repro_torch.core import (analyses, collector, comparison, compat,
                                  counters, events, graphframe, hlo, hlo_cost,
                                  regions, roofline, timeline)

    got = getattr(core, name)
    modules = {m.__name__.rsplit(".", 1)[-1]: m for m in (
        analyses, comparison, compat, counters, graphframe, hlo, hlo_cost,
        regions, timeline)}
    if name in modules:
        assert got is modules[name]
        return
    owners = [m for m in (collector, counters, comparison, events, graphframe,
                          regions, roofline) if name in vars(m)]
    assert owners and all(vars(m)[name] is got for m in owners), name


def test_quickstart_import_works():
    from repro_torch.core import annotate, regions, timeline
    from repro_torch.core import (GraphFrame, HW, annotate_torch,
                                  compare_frames)

    assert annotate is regions.annotate
    assert annotate_torch is regions.annotate_torch
    assert callable(timeline.to_chrome_trace)
    assert GraphFrame and HW and compare_frames


def test_counters_import_leaves_torch_out():
    code = ("import sys, repro_torch.core.counters, repro_torch.core; "
            "print(sorted(m for m in ('torch', 'jax', 'repro') "
            "if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"
