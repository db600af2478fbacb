"""The frozen FLOP and byte counts against counts made by hand."""
from __future__ import annotations

import pytest

from chipbench import cells, weights
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
    return cells.dims(dict(cfg, num_hidden_layers=layers))


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


def _small(**keys) -> dict:
    """A small configuration file of the keys every family reads."""
    c = {"name": "small", "arch": "small", "reference": "hybrid",
         "torch_dtype": "bfloat16", "hidden_size": 64,
         "intermediate_size": 96, "num_attention_heads": 4,
         "num_key_value_heads": 2, "num_hidden_layers": 1,
         "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
         "assumed": {"moe_capacity_factor": 1.25, "moe_token_group": 4096}}
    return cells.dims(dict(c, **keys))


ATTN = 64 * 64 + 2 * 64 * 32 + 64 * 64      # wq, wk, wv (K·D 32), wo


def test_a_windowed_layer_by_hand():
    d = _small(layer_types=["sliding_attention"], sliding_window=2)
    assert d["windows"] == [2] and d["layers"] == [("attn", "mlp")]
    p = ATTN + 3 * 64 * 96
    assert work.layer_params(d) == p
    head = 2 * 64 * 256
    # P 5, window 2: the rows see 1, 2, 2, 2, 2 keys
    assert work.prefill_flops(d, 1, 5) == 2 * p * 5 + 4 * 4 * 16 * 9 + head
    # a decode step at 5 positions reads its last 2 alone
    assert work.decode_flops(d, 3, 5) == 3 * (2 * p + 4 * 4 * 16 * 2 + head)
    assert work.train_flops(d, 1, 5) == 3 * (2 * p * 5 + 4 * 4 * 16 * 9
                                             + head * 5)
    ring = 2 * 3 * 2 * 2 * 16 * 2                # k and v, B 3, 2 slots
    assert work.decode_bytes(d, 3, 5) == ((p + 64 * 256) * 2 + 3 * 64 * 2
                                          + ring)
    glob = _small()
    assert work.decode_bytes(glob, 3, 5) - work.decode_bytes(d, 3, 5) == \
        2 * 3 * 3 * 2 * 16 * 2                   # the 3 slots the ring drops


def test_a_shared_expert_by_hand():
    d = _small(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=8,
               num_shared_experts=2)
    assert d["layers"] == [("attn", "moe")]
    assert (d["n_shared"], d["d_shared"]) == (2, 16)
    # the router, two experts of 8 and the shared experts' 16, always on
    moe = 64 * 4 + 2 * 3 * 64 * 8 + 3 * 64 * 16
    assert work.layer_params(d) == ATTN + moe
    table = weights.specs(d)
    assert table["layers.0.ffn.shared_wi"] == ((64, 16), "normal", 0.02)
    assert table["layers.0.ffn.wg"] == ((16, 64, 8), "normal", 0.02)


def test_leading_dense_layers_by_hand():
    d = _small(num_hidden_layers=3, num_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=8, num_dense_layers=1)
    assert d["layers"] == [("attn", "mlp"), ("attn", "moe"), ("attn", "moe")]
    moe = 64 * 4 + 2 * 3 * 64 * 8
    assert work.layer_params(d) == 3 * ATTN + 3 * 64 * 96 + 2 * moe
    by_types = _small(num_hidden_layers=3, num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=8,
                      mlp_layer_types=["dense", "sparse", "sparse"])
    assert by_types["layers"] == d["layers"]


def test_a_family_adds_its_own_matmul_parameters():
    d = _small(num_hidden_layers=2)
    plain = work.layer_params(d)
    d["extra_params"] = [64 * 64, 0]             # an output gate on layer 0
    assert work.layer_params(d) == plain + 64 * 64


# Trinity-Mini's config.json as the catalog gives it
# (https://huggingface.co/arcee-ai/Trinity-Mini/blob/main/config.json)
TRINITY = {
    "global_attn_every_n_layers": 4, "head_dim": 128, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 6144,
    "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
    "load_balance_coeff": 0.001, "max_position_embeddings": 131072,
    "model_type": "afmoe", "moe_intermediate_size": 1024,
    "mup_enabled": True, "n_group": 1, "num_attention_heads": 32,
    "num_dense_layers": 2, "num_expert_groups": 1, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 32,
    "num_key_value_heads": 4, "num_limited_groups": 1,
    "num_shared_experts": 1, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 10000, "route_norm": True, "route_scale": 2.826,
    "score_func": "sigmoid", "sliding_window": 2048,
    "tie_word_embeddings": False, "topk_group": 1, "use_grouped_mm": True,
    "vocab_size": 200192,
}


def _trinity() -> dict:
    c = dict(TRINITY, layer_types=TRINITY["layer_types"] * 8,
             name="trinity-mini", arch="trinity-mini",
             # a stand-in family: its sigmoid router is its own
             reference="hybrid", torch_dtype="bfloat16",
             assumed={"moe_capacity_factor": 1.25, "moe_token_group": 4096})
    return cells.dims(c)


def test_a_trinity_mini_shaped_configuration_by_hand():
    d = _trinity()
    assert d["n_layers"] == 32 and all(m == "attn" for m, _ in d["layers"])
    assert d["windows"].count(None) == 8 and d["windows"].count(2048) == 24
    assert d["windows"][:4] == [2048, 2048, 2048, None]
    assert [f for _, f in d["layers"]] == ["mlp"] * 2 + ["moe"] * 30
    assert (d["n_experts"], d["top_k"], d["n_shared"]) == (128, 8, 1)
    assert (d["d_expert"], d["d_shared"], d["d_ff"]) == (1024, 1024, 6144)
    E, V = 2048, 200192
    attn = E * 32 * 128 + 2 * E * 4 * 128 + 32 * 128 * E
    dense = 3 * E * 6144
    moe = E * 128 + 8 * 3 * E * 1024 + 3 * E * 1024
    p = 32 * attn + 2 * dense + 30 * moe
    assert work.layer_params(d) == p
    # B 1, P 4096: a full layer's rows see 1..4096 keys, a windowed one's
    # 1..2048 and then 2048 each
    full = 4096 * 4097 // 2
    windowed = 2048 * 2049 // 2 + (4096 - 2048) * 2048
    want = (2 * p * 4096 + 4 * 32 * 128 * (8 * full + 24 * windowed)
            + 2 * E * V)
    assert work.prefill_flops(d, 1, 4096) == want


def test_port_config_names_the_architecture_the_port_lacks():
    with pytest.raises(SystemExit, match="no architecture 'trinity-mini'"):
        cells.port_config(_trinity())
