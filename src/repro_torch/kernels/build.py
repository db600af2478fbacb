"""Build and load the port's CUDA kernels.

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/repro_torch/`` at the
root of the checkout, named by the source's hash, and loaded with
``ctypes``. :func:`build` compiles every source that has no library yet,
one ``nvcc`` per source, all started together. Nothing is built or loaded
when this module is imported. A missing ``nvcc`` or a failed build raises:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

KERNELS = Path(__file__).resolve().parent
SOURCES = {
    "flash_fwd": KERNELS / "flash_attention" / "csrc" / "flash_fwd.cu",
    "flash_bwd": KERNELS / "flash_attention" / "csrc" / "flash_bwd.cu",
    "selective_scan": KERNELS / "mamba_scan" / "csrc" / "selective_scan.cu",
}
BUILD_DIR = KERNELS.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_CUDA_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or _CUDA_NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    digest = hashlib.sha1(SOURCES[name].read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build() -> Dict[str, Path]:
    """Compile every source whose library does not exist yet, one ``nvcc``
    per source, all started together; return each library's path by name.
    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<name>.log``."""
    libs = {name: library_path(name) for name in SOURCES}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {SOURCES[name].name} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        todo[name].with_suffix(".log").write_text(out + err)
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of source ``name``, built first if needed. The caller
    declares each entry point's ``argtypes`` and ``restype``."""
    return ctypes.CDLL(str(build()[name]))


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the integer a kernel's C
    entry point takes."""
    return torch.cuda.current_stream(device).cuda_stream
