"""End-to-end driver: train a ~100M-param LM for a few hundred steps
(the port of ``examples/train_e2e.py``).

    PYTHONPATH=src python examples/train_e2e_torch.py --preset tiny --device cpu
    PYTHONPATH=src python examples/train_e2e_torch.py --preset 100m

Wraps repro_torch.launch.train with two presets:
  tiny — ~4M params, 300 steps, finishes on 1 CPU core in minutes and
         shows the loss dropping on the structured synthetic stream.
  100m — ~100M params (d_model 768, 12 layers), few hundred steps;
         sized for one card.
Both checkpoint every 50 steps (under the temporary directory unless
``--ckpt-dir`` is given) and resume with --resume. Trains on the CUDA card
unless ``--device cpu`` is given.
"""
import argparse
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    steps = args.steps or 300
    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         f"e2e_torch_{args.preset}")
    if args.preset == "tiny":
        argv = ["--arch", "yi-6b", "--preset", "smoke",
                "--steps", str(steps), "--batch", "8", "--seq", "128",
                "--d-model", "128", "--layers", "4",
                "--ckpt-dir", ckpt, "--ckpt-every", "50",
                "--lr", "1e-3"]
    else:
        argv = ["--arch", "yi-6b", "--preset", "smoke",
                "--steps", str(steps), "--batch", "8", "--seq", "512",
                "--d-model", "768", "--layers", "12",
                "--ckpt-dir", ckpt, "--ckpt-every", "50",
                "--lr", "3e-4"]
    argv += ["--device", args.device]
    if args.resume:
        argv.append("--resume")
    losses, stats = train.main(argv)
    assert all(math.isfinite(x) for x in losses), "loss is not finite"
    print(f"\ne2e {args.preset}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps ({stats['mean_step_ms']:.1f} ms a step)")
    return losses, stats


if __name__ == "__main__":
    main()
