"""The numbers that decide ``correct``, each computed from what the
timed path produced and the reference's answer to the same inputs."""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch


def percentile(values: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """At every position, the gap by which the reference's logit of the
    served token lies below the reference's best (0 where the served
    token is the reference's best); infinite for a token outside the
    vocabulary."""
    if served.min() < 0 or served.max() >= vocab:
        return torch.full(served.shape, math.inf)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served[..., None])[..., 0]
    return (best - got).flatten().cpu()


def gap_readings(gaps: torch.Tensor) -> Dict[str, float]:
    """The numbers a cell may compare, over the gaps of every sampled
    position: ``logit_gap``, the widest; ``mean_gap``; ``miss_share``,
    the share of positions whose token is not the reference's best."""
    return {"logit_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "miss_share": float((gaps > 0).float().mean())}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             skip: Sequence[str] = ()) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; ``skip`` names leaves left out."""
    names = [n for n in ref if n not in skip]
    median = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
               for n in names)


def within(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every reading that ``limits`` names is within its limit."""
    return all(math.isfinite(readings[k]) and readings[k] <= v
               for k, v in limits.items())
