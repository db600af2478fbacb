"""The port stands alone: no JAX, no ``repro`` package, and no silent CPU
fallback when a card was asked for."""
import ast
import os

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_exist():
    files = port_files()
    assert os.path.join(REPO, "chip_smoke.py") in files
    assert len(files) > 15


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_imports(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_serve_without_device_flag_raises_on_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--gen", "1"])


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
