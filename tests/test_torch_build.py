"""The port's kernel build names each library by everything that builds it.

``repro_torch.kernels.build.library_path`` hashes a CUDA source, every
``*.cuh`` header beside it (which the source may include) and the compiler
flags, so that an edit to a shared header or a flag builds anew instead of
loading a stale library. Sources are copied under ``tmp_path`` and edited
there; nothing is compiled (this host has no ``nvcc``).
"""
import shutil

import pytest

from repro_torch.kernels import build as kbuild

FLASH = ("flash_fwd", "flash_bwd")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the flash-attention sources, which ``build`` then names."""
    src = kbuild.SOURCES["flash_fwd"].parent
    dst = tmp_path / "csrc"
    shutil.copytree(src, dst)
    for name in FLASH:
        monkeypatch.setitem(kbuild.SOURCES, name,
                            dst / kbuild.SOURCES[name].name)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    return dst


def test_the_flash_sources_share_a_header():
    headers = sorted(kbuild.SOURCES["flash_fwd"].parent.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper.cuh"]
    for name in FLASH:
        assert '#include "hopper.cuh"' in kbuild.SOURCES[name].read_text()


@pytest.mark.parametrize("name", FLASH)
def test_editing_the_shared_header_renames_the_library(csrc, name):
    before = kbuild.library_path(name)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = kbuild.library_path(name)
    assert after != before
    assert after.parent == before.parent and after.name.startswith(f"lib{name}_")


@pytest.mark.parametrize("name", FLASH)
def test_editing_the_source_renames_its_library_only(csrc, name):
    other = FLASH[1 - FLASH.index(name)]
    before = {n: kbuild.library_path(n) for n in FLASH}
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert kbuild.library_path(name) != before[name]
    assert kbuild.library_path(other) == before[other]


@pytest.mark.parametrize("name", FLASH)
def test_editing_an_unrelated_file_keeps_the_name(csrc, name):
    before = kbuild.library_path(name)
    (csrc / "notes.txt").write_text("not a source\n")
    (csrc.parent / "elsewhere.cuh").write_text("// another directory\n")
    assert kbuild.library_path(name) == before


def test_a_new_header_beside_the_source_renames_the_library(csrc):
    before = kbuild.library_path("flash_fwd")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kbuild.library_path("flash_fwd") != before


@pytest.mark.parametrize("name", [*FLASH, "selective_scan"])
def test_changing_the_flags_renames_the_library(monkeypatch, name):
    before = kbuild.library_path(name)
    monkeypatch.setattr(kbuild, "NVCC_FLAGS", (*kbuild.NVCC_FLAGS, "-lineinfo"))
    assert kbuild.library_path(name) != before


@pytest.mark.parametrize("name", [*FLASH, "selective_scan"])
def test_the_name_is_stable(name):
    assert kbuild.library_path(name) == kbuild.library_path(name)
    assert kbuild.library_path(name).parent == kbuild.BUILD_DIR
