"""FLOPs and bytes counted from shapes: each kernel's, and the model's.

``unmasked_pairs``, ``attention_work``, ``backward_work`` and
``scan_work`` are copied from ``src/repro_torch/core/cost.py`` at commit
5ccc2ae. The model FLOPs follow the arithmetic of
``src/repro_torch/launch/flops.py`` (same commit): 2 FLOPs a matmul
parameter a token forward (6 with the backward), causal attention at its
unmasked (q, k) pairs (a windowed layer's within its window), 10·d_inner·
d_state a token a mamba layer; they count the lm_head at the positions
whose logits the step computes (the last one in a prefill). A layer's
matmul parameters are its mixer's, its FFN's (an MoE layer's router, its
top-k experts and its shared experts) and the family's ``extra_params``.
``dims`` is the dict of :func:`chipbench.cells.dims`.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional, Tuple


def unmasked_pairs(T: int, S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs that the causal/window mask lets through."""
    pairs = 0
    for t in range(T):
        hi = min(t, S - 1) if causal else S - 1
        lo = max(0, t - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def attention_work(B: int, T: int, S: int, H: int, K: int, D: int,
                   causal: bool, window: Optional[int], itemsize: int
                   ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one forward call: 4·D useful FLOPs per unmasked
    (q, k) pair per head (s and p·v); q, k, v read once, out and the f32
    lse written once."""
    flops = 4 * D * B * H * unmasked_pairs(T, S, causal, window)
    nbytes = (2 * B * T * H * D + 2 * B * S * K * D) * itemsize + B * H * T * 4
    return flops, nbytes


def backward_work(B: int, T: int, S: int, H: int, K: int, D: int,
                  causal: bool, window: Optional[int], itemsize: int
                  ) -> Dict[str, Tuple[int, int]]:
    """(FLOPs, bytes) of each backward kernel: 6·D FLOPs per unmasked pair
    per head for dq (s, dp, ds·k) and 8·D for dk/dv (s, dp, pᵀ·do,
    dsᵀ·q); q, k, v, do, lse, delta read once, dq (or dk, dv) written
    once. Returns {"dq": (flops, bytes), "dkv": (flops, bytes)}."""
    pairs = B * H * unmasked_pairs(T, S, causal, window)
    reads = ((2 * B * T * H * D + 2 * B * S * K * D) * itemsize
             + 2 * B * H * T * 4)
    return {name: (per_pair * D * pairs, reads + written * itemsize)
            for name, per_pair, written in (("dq", 6, B * T * H * D),
                                            ("dkv", 8, 2 * B * S * K * D))}


def scan_work(B: int, T: int, dI: int, N: int, x_item: int, p_item: int,
              chunks: int = 0) -> Tuple[int, int, int]:
    """(f32 FLOPs, ex2 evaluations, bytes) of one selective-scan call: 6
    FLOPs per (b, t, d, n) (dt·A, dx·B, two FMAs) and 3 per (b, t, d)
    (dt·x, an FMA with D); one ex2 per (b, t, d, n); x, dt, B, C, A, D read
    once, y and the final state written once, and ``chunks`` f32 states
    when a training forward saves them."""
    nbytes = (B * T * dI * (2 * x_item + p_item) + 2 * B * T * N * p_item
              + dI * N * 4 + dI * 4 + B * dI * N * 4 * (1 + chunks))
    return B * T * dI * (6 * N + 3), B * T * dI * N, nbytes


# ---------------------------------------------------------------------------
# least times (the roofline's bound)
# ---------------------------------------------------------------------------

def least_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes: float, exps: float = 0.0, peak_exps: float = 1.0
            ) -> float:
    """The least time of a call: the largest of its FLOPs over the peak
    rate, its ex2 evaluations over the SFU's rate and its bytes over the
    memory's rate."""
    return max(flops / peak_flops, exps / peak_exps, nbytes / peak_bytes)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _attn_params(d: dict) -> int:
    E, H, K, D = d["d_model"], d["n_heads"], d["n_kv_heads"], d["head_dim"]
    return E * H * D + 2 * E * K * D + H * D * E


def _mamba_params(d: dict) -> int:
    E = d["d_model"]
    dI, N, R = d["d_inner"], d["d_state"], d["dt_rank"]
    return E * 2 * dI + dI * (R + 2 * N) + R * dI + dI * E


def _ffn_params(d: dict, ffn: str) -> int:
    E = d["d_model"]
    if ffn == "mlp":
        return 3 * E * d["d_ff"]
    # the router, the top-k experts a token runs through and the shared
    # experts every token runs through
    return (E * d["n_experts"] + d["top_k"] * 3 * E * d["d_expert"]
            + 3 * E * d["d_shared"])


def layer_params(d: dict) -> int:
    """Matmul parameters a token meets in the layers (active experts
    only): no embedding gather, no lm_head."""
    n = 0
    for (mixer, ffn), extra in zip(d["layers"], d["extra_params"],
                                   strict=True):
        n += _attn_params(d) if mixer == "attn" else _mamba_params(d)
        n += _ffn_params(d, ffn) + extra
    return n


def attn_windows(d: dict) -> Dict[Optional[int], int]:
    """The attention layers by window (None: global): window -> layers,
    in the order the windows first appear."""
    return dict(Counter(w for (mixer, _), w in
                        zip(d["layers"], d["windows"], strict=True)
                        if mixer == "attn"))


def seen(ctx: int, window: Optional[int]) -> int:
    """Positions a new token at ``ctx`` (itself included) attends."""
    return ctx if window is None else min(ctx, window)


def _mix_flops(d: dict, pairs_of: Callable[[Optional[int]], int],
               tokens: int) -> float:
    """Sequence mixing beyond the parameter matmuls: 4·H·D a (q, k) pair
    an attention layer (``pairs_of(window)`` a row), 10·d_inner·d_state a
    token a mamba layer."""
    n_mamba = sum(m == "mamba" for m, _ in d["layers"])
    f = 0.0
    for window, n_attn in attn_windows(d).items():
        f += 4.0 * d["n_heads"] * d["head_dim"] * pairs_of(window) * n_attn
    if n_mamba:
        f += 10.0 * d["d_inner"] * d["d_state"] * tokens * n_mamba
    return f


def prefill_flops(d: dict, B: int, P: int) -> float:
    """Model FLOPs of a prefill of B prompts of P tokens: logits at the
    last position only."""
    return (2.0 * layer_params(d) * B * P
            + B * _mix_flops(d, lambda w: unmasked_pairs(P, P, True, w), P)
            + 2.0 * d["d_model"] * d["vocab_size"] * B)


def decode_flops(d: dict, B: int, ctx: int) -> float:
    """Model FLOPs of one decode step of B sequences whose new token sees
    ``ctx`` positions (itself included; a windowed layer's at most its
    window)."""
    return (2.0 * layer_params(d) * B
            + B * _mix_flops(d, lambda w: seen(ctx, w), 1)
            + 2.0 * d["d_model"] * d["vocab_size"] * B)


def train_flops(d: dict, B: int, T: int) -> float:
    """Model FLOPs of one training step of B rows of T tokens: 3× the
    forward (forward and backward), no recompute counted."""
    fwd = (2.0 * layer_params(d) * B * T
           + B * _mix_flops(d, lambda w: unmasked_pairs(T, T, True, w), T)
           + 2.0 * d["d_model"] * d["vocab_size"] * B * T)
    return 3.0 * fwd


def decode_bytes(d: dict, B: int, ctx: int, itemsize: int = 2) -> float:
    """Bytes one decode step must move: every weight matrix it uses read
    once (an MoE layer's top_k experts, the fewest a token can use, and
    its shared experts), the lm_head, the filled KV cache read (a
    windowed layer's ring: at most its window) and the new keys and
    values written, each mamba state read and written (f32) with its
    conv tail."""
    E, K, D = d["d_model"], d["n_kv_heads"], d["head_dim"]
    weights = layer_params(d) + E * d["vocab_size"]
    n = weights * itemsize + B * E * itemsize
    for (mixer, _ffn), window in zip(d["layers"], d["windows"], strict=True):
        if mixer == "attn":
            n += 2 * B * seen(ctx, window) * K * D * itemsize
        else:
            dI, N = d["d_inner"], d["d_state"]
            n += 2 * B * dI * N * 4 + 2 * B * (d["d_conv"] - 1) * dI * itemsize
    return float(n)
