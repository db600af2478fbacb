"""The frozen FLOP and byte counts against counts made by hand."""
from __future__ import annotations

import pytest

from chipbench import cells
from chipbench.frozen import work
from chipbench.frozen.peaks import PEAK_BF16_FLOPS, PEAK_BYTES


def test_unmasked_pairs():
    assert work.unmasked_pairs(4, 4, True, None) == 4 + 3 + 2 + 1
    assert work.unmasked_pairs(4, 4, False, None) == 16
    assert work.unmasked_pairs(5, 5, True, 2) == 1 + 2 + 2 + 2 + 2


def test_attention_forward_by_hand():
    # B 1, T = S = 2, H 2, K 1, D 8, causal: 3 pairs a head, 4·D FLOPs each
    flops, nbytes = work.attention_work(1, 2, 2, 2, 1, 8, True, None, 2)
    assert flops == 4 * 8 * 2 * 3
    # q and out (2·T·H·D), k and v (2·S·K·D) in bf16, the f32 lse (H·T)
    assert nbytes == (2 * 2 * 2 * 8 + 2 * 2 * 1 * 8) * 2 + 2 * 2 * 4


def test_attention_backward_by_hand():
    out = work.backward_work(1, 2, 2, 2, 1, 8, True, None, 2)
    reads = (2 * 2 * 2 * 8 + 2 * 2 * 1 * 8) * 2 + 2 * 2 * 2 * 4
    assert out["dq"] == (6 * 8 * 2 * 3, reads + 2 * 2 * 8 * 2)
    assert out["dkv"] == (8 * 8 * 2 * 3, reads + 2 * 2 * 1 * 8 * 2)


def test_scan_by_hand():
    flops, exps, nbytes = work.scan_work(1, 2, 3, 4, 2, 4)
    assert flops == 2 * 3 * (6 * 4 + 3) and exps == 2 * 3 * 4
    # x and y (bf16), dt (f32) per (t, d); B and C per (t, n); A, D; state
    assert nbytes == 2 * 3 * (2 * 2 + 4) + 2 * 2 * 4 * 4 + 3 * 4 * 4 + 3 * 4 \
        + 3 * 4 * 4


def test_least_time_takes_the_larger_bound():
    assert work.least_s(989e12, 0, PEAK_BF16_FLOPS, PEAK_BYTES) == 1.0
    assert work.least_s(0, 3.35e12, PEAK_BF16_FLOPS, PEAK_BYTES) == 1.0
    assert work.least_s(1, 1, 1e9, 1e9, exps=4e9, peak_exps=2e9) == 2.0


def _yi(layers: int) -> dict:
    cfg = cells.load_json(cells.HERE / "configs" / "yi-6b.json")
    return dict(cells.dims(cfg), n_layers=layers,
                layers=[("attn", "mlp")] * layers)


def test_yi_parameters_by_hand():
    d = _yi(32)
    per_layer = (4096 * 4096 * 2 + 4096 * 512 * 2) + 3 * 4096 * 11008
    assert work.layer_params(d) == 32 * per_layer
    # yi-6b: 6.06e9 parameters with its embedding and head
    total = work.layer_params(d) + 2 * 64000 * 4096
    assert total == pytest.approx(6.06e9, rel=0.01)


def test_yi_model_flops_by_hand():
    d = _yi(1)
    p = work.layer_params(d)
    head = 2 * 4096 * 64000
    pairs = 3 * 4 // 2                       # T 3, causal: 6 pairs
    attn = 4 * 32 * 128 * pairs
    assert work.prefill_flops(d, 1, 3) == 2 * p * 3 + attn + head
    assert work.decode_flops(d, 2, 5) == 2 * (2 * p + 4 * 32 * 128 * 5 + head)
    assert work.train_flops(d, 1, 3) == 3 * (2 * p * 3 + attn + head * 3)


def test_decode_bytes_by_hand():
    d = _yi(1)
    weights = work.layer_params(d) + 4096 * 64000
    cache = 2 * 2 * 7 * 4 * 128 * 2          # k and v, B 2, 7 positions
    assert work.decode_bytes(d, 2, 7) == weights * 2 + 2 * 4096 * 2 + cache


def test_jamba_active_parameters_by_hand():
    cfg = cells.load_json(cells.HERE / "configs" / "jamba-v0.1-52b.l16.json")
    d = cells.dims(cfg)
    E, dI, R, N = 4096, 8192, 256, 16
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    mamba = E * 2 * dI + dI * (R + 2 * N) + R * dI + dI * E
    mlp, moe = 3 * E * 14336, E * 16 + 2 * 3 * E * 14336
    want = 2 * attn + 14 * mamba + 8 * mlp + 8 * moe
    assert d["layers"][4] == ("attn", "mlp") and d["layers"][1] == ("mamba", "moe")
    assert work.layer_params(d) == want
