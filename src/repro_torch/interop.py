"""Carry weights from the JAX package's parameter tree into the port.

``params_from_jax`` takes the tree that ``repro.models.model.init_params``
returns, with its leaves as numpy arrays, and returns a state dict that
:meth:`repro_torch.models.model.Model.load_state_dict` takes. Matrices keep
JAX's ``(in, out)`` layout, which the port also uses (``x @ w``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ModelConfig


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, including ``ml_dtypes.bfloat16`` arrays, which
    ``torch.from_numpy`` rejects: their bits go through int16."""
    a = np.array(a)          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flatten(leaf, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", leaf


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device) -> Dict[str, torch.Tensor]:
    """Unstack each ``pos{i}`` group over its leading ``layers`` axis:
    layer ``l`` is group ``l // len(pattern)`` at position
    ``l % len(pattern)``. Nested leaves (``mixer.A_log``, ``ffn.router``)
    keep their paths, stacked experts ``(n_groups, Ne, E, F)`` become
    ``(Ne, E, F)``, and every leaf keeps its dtype until
    ``load_state_dict`` copies it into the parameter's."""
    plen = len(cfg.pattern)
    state: Dict[str, torch.Tensor] = {}
    for name in ("embed", "final_norm", "lm_head"):
        state[name] = tensor_from_numpy(np_tree[name], device)
    for l in range(cfg.n_layers):
        group = np_tree[f"pos{l % plen}"]
        for path, stacked in _flatten(group):
            state[f"layers.{l}.{path}"] = tensor_from_numpy(
                np.asarray(stacked)[l // plen], device)
    return state
