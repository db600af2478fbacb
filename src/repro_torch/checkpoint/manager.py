"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``).

  * atomic commits: write to ``step_K.tmp-<nonce>/``, fsync, rename —
    a crash mid-save never corrupts the latest checkpoint
  * async save: the train loop hands off a host snapshot to a background
    thread (the paper's progress-thread pattern: a second queue so the
    producer — the training step — never blocks on I/O)
  * retention: keep the newest ``keep`` checkpoints
  * restore: latest or explicit step; arrays come back as CPU tensors and
    are moved to a device by the caller
  * preemption hook: ``install_signal_handler`` saves synchronously on
    SIGTERM before re-raising

The files are the JAX package's: ``arrays.npz`` (one array per
``/``-joined path), ``metadata.json`` and ``COMMITTED``. Tensors go to
numpy through ``.cpu()``; numpy has no bfloat16, so bf16 tensors are
stored as their int16 bits and listed under ``"bfloat16"`` in the
metadata, which restore reads to view them back.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import signal
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import regions


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async = async_save
        self._queue: "queue.Queue[Optional[Tuple[int, dict, dict]]]" = (
            queue.Queue(maxsize=2))
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_save:
            self._worker = threading.Thread(
                target=self._drain, name="ckpt-saver", daemon=True)
            self._worker.start()

    # -- public API ---------------------------------------------------------

    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[dict] = None, block: bool = False) -> None:
        """Snapshot to host memory and enqueue the write. The snapshot
        copies device tensors to the host, so it waits for the device."""
        if self._error:
            raise RuntimeError("checkpoint writer failed") from self._error
        with regions.annotate("ckpt/snapshot", category="runtime", step=step):
            flat = dict(_flatten(state))
            host = {k: _to_numpy(v) for k, v in flat.items()}
        meta = dict(metadata or {})
        meta["bfloat16"] = sorted(
            k for k, v in flat.items()
            if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16)
        item = (step, host, meta)
        if self._async and not block:
            self._queue.put(item)
        else:
            self._write(*item)

    def wait(self) -> None:
        """Barrier: all enqueued saves are durable."""
        if self._async:
            self._queue.join()
        if self._error:
            raise RuntimeError("checkpoint writer failed") from self._error

    def restore(self, step: Optional[int] = None
                ) -> Optional[Tuple[int, Dict[str, Any], dict]]:
        """(step, tree of CPU tensors, metadata), or None if there is no
        committed checkpoint."""
        steps = self.available_steps()
        if not steps:
            return None
        step = step if step is not None else steps[-1]
        path = os.path.join(self.directory, f"step_{step:010d}")
        with regions.annotate("ckpt/restore", category="runtime", step=step):
            with open(os.path.join(path, "metadata.json")) as f:
                meta = json.load(f)
            bf16 = set(meta.get("bfloat16", ()))
            with np.load(os.path.join(path, "arrays.npz")) as zf:
                flat = {}
                for k in zf.files:
                    t = torch.from_numpy(np.array(zf[k]))
                    flat[k] = t.view(torch.bfloat16) if k in bf16 else t
        return step, _unflatten(flat), meta

    def available_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                full = os.path.join(self.directory, name)
                if os.path.exists(os.path.join(full, "COMMITTED")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def install_signal_handler(self, state_fn: Callable[[], Tuple[int, dict]]):
        """Save synchronously on SIGTERM (preemption notice), then re-raise."""
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            step, state = state_fn()
            self.save(step, state, {"reason": "preemption"}, block=True)
            if callable(prev):
                prev(signum, frame)
            else:
                signal.default_int_handler(signum, frame)

        signal.signal(signal.SIGTERM, handler)

    def close(self):
        if self._async and self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=60)

    # -- internals ------------------------------------------------------------

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            try:
                self._write(*item)
            except BaseException as e:       # surfaced on next save()/wait()
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, host: Dict[str, np.ndarray], meta: dict):
        with regions.annotate("ckpt/write", category="runtime", step=step):
            final = os.path.join(self.directory, f"step_{step:010d}")
            tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            meta = dict(meta)
            meta.update(step=step, time=time.time(),
                        n_arrays=len(host))
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

    def _gc(self):
        steps = self.available_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
        # remove orphaned tmp dirs from crashed writers
        for name in os.listdir(self.directory):
            if ".tmp-" in name:
                full = os.path.join(self.directory, name)
                if time.time() - os.path.getmtime(full) > 3600:
                    shutil.rmtree(full, ignore_errors=True)
