"""Device choice for the port's entry points, decided at call time, and
waiting for the work queued on a card."""
from __future__ import annotations

from typing import Any, Iterator

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


def tensors(obj: Any) -> Iterator[torch.Tensor]:
    """The tensors in a (nested) dict, list or tuple."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v)


def cuda_devices(*objs: Any) -> set:
    """The CUDA devices that hold a tensor of ``objs`` (nested)."""
    return {t.device for o in objs for t in tensors(o) if t.is_cuda}


def fence(*objs: Any) -> None:
    """Wait until the current stream of every card holding a tensor of
    ``objs`` has run what was queued on it (the counterpart of
    ``jax.block_until_ready``). Tensors on the CPU are complete when
    issued."""
    for dev in cuda_devices(*objs):
        torch.cuda.current_stream(dev).synchronize()
