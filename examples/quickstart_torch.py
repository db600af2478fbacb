"""Quickstart: profile a small LM training run with the core library
(the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Demonstrates the 60-second path: annotate regions -> train a few steps ->
print the Hatchet-style tree -> export a Chromium trace you can open in
chrome://tracing or Perfetto (the paper's viewers). Trains on the CUDA
card unless ``--device cpu`` is given.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.archs import get_config
from repro_torch.core import annotate, regions, timeline  # noqa: F401
from repro_torch.core.collector import global_collector, reset_global_collector
from repro_torch.core.graphframe import GraphFrame
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import fence, resolve_device
from repro_torch.launch.train import to_device
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("yi-6b", "smoke")
    data = SyntheticTokens(cfg, DataConfig(batch=4, seq_len=128))
    model = Model(cfg, device, trainable=True).init_weights(0)
    opt = adamw.init_state(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.AdamWConfig(total_steps=args.steps))

    reset_global_collector()
    losses = []
    for i in range(args.steps):
        with annotate("train/step", step=i):
            with annotate("train/data", category="data"):
                batch = to_device(data.batch_at(i), device)
            with annotate("train/compute", category="api"):
                metrics = step(model, opt, batch)
                fence(metrics["loss"])
        losses.append(float(metrics["loss"]))
        print(f"step {i}: loss {losses[-1]:.4f}")

    events = global_collector().drain()
    gf = GraphFrame.from_events(events)
    print("\nregion tree (mean seconds per occurrence):")
    print(gf.tree(metric="mean", fmt="{:.4f}"))
    out = os.path.join(tempfile.gettempdir(), "quickstart_torch_trace.json")
    timeline.save_trace(timeline.to_chrome_trace(events), out)
    print(f"\nchrome trace written to {out} (open in chrome://tracing)")
    return losses


if __name__ == "__main__":
    main()
