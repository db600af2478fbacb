"""Device choice for the port's entry points, decided at call time."""
from __future__ import annotations

import torch


def resolve_device(requested: str = "cuda") -> torch.device:
    """Return the device to run on.

    ``cpu`` is returned only when the caller asked for it; a request for
    ``cuda`` on a host without a card raises instead of falling back.
    """
    dev = torch.device(requested)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {requested!r}; use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {requested!r} requested but no CUDA card is available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
