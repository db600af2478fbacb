"""From a configuration file to the port's model: what :func:`cells.dims`
reads, what :func:`cells.port_config` accepts and refuses, the weight
table each family gives, and the work counts and reference logits of the
benchmark's configurations pinned to values taken from the harness
before each family owned its own keys and table (the same code run on
the CPU, written here as literals)."""
from __future__ import annotations

import dataclasses
import hashlib
import json

import pytest
import torch

from chipbench import cells, traffic, weights
from chipbench.frozen import work
from chipbench.reference import dense, hybrid

FILES = {"yi-6b": "configs/yi-6b.json",
         "yi-6b.stage8": "configs/yi-6b.stage8.json",
         "jamba-v0.1-52b.l16": "configs/jamba-v0.1-52b.l16.json",
         "gemma3-12b": "fixtures/gemma3-12b.json",
         "deepseek-moe-16b": "fixtures/deepseek-moe-16b.json"}


def _config(name: str) -> dict:
    return cells.load_json(cells.HERE / FILES[name])


def _dims(name: str, smoke: bool = False) -> dict:
    return cells.dims(_config(name), smoke)


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the benchmark's configurations, pinned
# ---------------------------------------------------------------------------

YI = {"name": "yi-6b", "arch": "yi-6b", "reference": "dense",
      "dtype": "bfloat16", "d_model": 4096, "n_heads": 32, "n_kv_heads": 4,
      "head_dim": 128, "d_ff": 11008, "vocab_size": 64000,
      "padded_vocab": 64000, "n_layers": 32, "rope_theta": 5000000.0,
      "norm_eps": 1e-06, "layers": [("attn", "mlp")] * 32}
YI_SMOKE = dict(YI, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                d_ff=128, vocab_size=256, padded_vocab=256, n_layers=1,
                layers=[("attn", "mlp")])
JAMBA_LAYERS = [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
                ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
                ("mamba", "mlp"), ("mamba", "moe")]
JAMBA = {"name": "jamba-v0.1-52b.l16", "arch": "jamba-v0.1-52b",
         "reference": "hybrid", "dtype": "bfloat16", "d_model": 4096,
         "n_heads": 32, "n_kv_heads": 8, "head_dim": 128, "d_ff": 14336,
         "vocab_size": 65536, "padded_vocab": 65536, "n_layers": 16,
         "rope_theta": 10000.0, "norm_eps": 1e-06, "n_experts": 16,
         "padded_experts": 16, "top_k": 2, "d_expert": 14336,
         "capacity_factor": 1.25, "token_group": 4096, "d_inner": 8192,
         "d_state": 16, "d_conv": 4, "dt_rank": 256,
         "layers": JAMBA_LAYERS * 2}
PINNED_DIMS = {
    ("yi-6b", False): YI,
    ("yi-6b", True): YI_SMOKE,
    ("yi-6b.stage8", False): dict(YI, name="yi-6b.stage8", n_layers=8,
                                  layers=[("attn", "mlp")] * 8),
    ("yi-6b.stage8", True): dict(YI_SMOKE, name="yi-6b.stage8"),
    ("jamba-v0.1-52b.l16", False): JAMBA,
    ("jamba-v0.1-52b.l16", True): dict(
        JAMBA, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=256, padded_vocab=256, n_layers=8, n_experts=8,
        d_expert=32, d_inner=128, d_state=4, dt_rank=4, layers=JAMBA_LAYERS),
}
# (parameters, checksum of [name, shape, initializer, scale] in order)
PINNED_SPECS = {
    ("yi-6b", False): (291, "6691d3cc8870b7c8"),
    ("yi-6b", True): (12, "624c34ffb6d0a8de"),
    ("yi-6b.stage8", False): (75, "5e799e20e9e0342f"),
    ("yi-6b.stage8", True): (12, "624c34ffb6d0a8de"),
    ("jamba-v0.1-52b.l16", False): (225, "f0eee77e9983983a"),
    ("jamba-v0.1-52b.l16", True): (114, "2cbf63ab0774989b"),
}
# checksum of the port's ModelConfig as port_config builds it
PINNED_PORT = {
    ("yi-6b", False): "8f8a9afb8ea70382",
    ("yi-6b", True): "c841558aef0921f2",
    ("yi-6b.stage8", False): "8ce0ca0542aa07b5",
    ("yi-6b.stage8", True): "c841558aef0921f2",
    ("jamba-v0.1-52b.l16", False): "13136653209890d1",
    ("jamba-v0.1-52b.l16", True): "94976e9d8861d6ea",
}


@pytest.mark.parametrize("key", list(PINNED_DIMS), ids=str)
def test_the_benchmark_configurations_read_as_before(key):
    name, smoke = key
    d = _dims(name, smoke)
    want = PINNED_DIMS[key]
    assert {k: d[k] for k in want} == want
    # what the files leave out reads as the defaults
    n = d["n_layers"]
    assert d["windows"] == [None] * n and d["extra_params"] == [0] * n
    assert d["act"] == "silu" and d["tie_embeddings"] is False
    if d["reference"] == "dense":
        assert d["qk_norm"] is False
    else:
        assert d["n_shared"] == 0 and d["d_shared"] == 0
    table = [[n, list(s[0]), s[1], s[2]] for n, s in weights.specs(d).items()]
    assert (len(table), _sha(table)) == PINNED_SPECS[key]
    cfg = cells.port_config(d, smoke)
    assert _sha(dataclasses.asdict(cfg)) == PINNED_PORT[key]


# prefill FLOPs at B, decode FLOPs and bytes summed over the gen steps,
# one step's FLOPs at P + 1 and bytes at P + gen, at each prompt length
PINNED_COUNTS = {
    ("yi-6b", 4, 16): {
        1024: (46457537167360.0, 776868986880.0, 189887152128.0,
               48538583040.0, 11869913088.0),
        2048: (95112000438272.0, 811228725248.0, 194182119424.0,
               50686066688.0, 12138348544.0),
        3072: (145965486964736.0, 845588463616.0, 198477086720.0,
               52833550336.0, 12406784000.0),
        4096: (199017996746752.0, 879948201984.0, 202772054016.0,
               54981033984.0, 12675219456.0)},
    ("jamba-v0.1-52b.l16", 4, 16): {
        1024: (47528175206400.0, 778044440576.0, 195245637632.0,
               48626794496.0, 12203098112.0),
        2048: (95191641882624.0, 780191924224.0, 195782508544.0,
               48761012224.0, 12236652544.0),
        3072: (142992547512320.0, 782339407872.0, 196319379456.0,
               48895229952.0, 12270206976.0),
        4096: (190930892095488.0, 784486891520.0, 196856250368.0,
               49029447680.0, 12303761408.0)},
    ("yi-6b", 32, 256): {
        256: (91278389805056.0, 96656091512832.0, 3175390117888.0,
              375423762432.0, 12671254528.0),
        512: (183639514021888.0, 97755603140608.0, 3312829071360.0,
              379718729728.0, 13208125440.0),
        768: (277100149866496.0, 98855114768384.0, 3450268024832.0,
              384013697024.0, 13744996352.0),
        1024: (371660297338880.0, 99954626396160.0, 3587706978304.0,
               388308664320.0, 14281867264.0)},
}


@pytest.mark.parametrize("key", list(PINNED_COUNTS), ids=str)
def test_the_serving_cells_work_counts_as_before(key):
    name, B, gen = key
    d = _dims(name)
    for P, want in PINNED_COUNTS[key].items():
        got = (work.prefill_flops(d, B, P),
               sum(work.decode_flops(d, B, P + j + 1) for j in range(gen)),
               sum(work.decode_bytes(d, B, P + j + 1) for j in range(gen)),
               work.decode_flops(d, B, P + 1), work.decode_bytes(d, B, P + gen))
        assert got == want, P


def test_the_training_cell_counts_as_before():
    assert work.train_flops(_dims("yi-6b.stage8"), 4, 4096) == 175031728472064.0


# (sum, sum of |x|, sum of x·(index mod 97)) of the smoke references'
# logits in f64: seed 7, two prompts of 16, logits from position 4, the
# first 12 positions one prefill; plain and with the fp8 control
PINNED_LOGITS = {
    ("yi-6b", None): (0.46938463764672633, 803.5424482870876,
                      -35.30068820263841),
    ("yi-6b", "fp8"): (0.19578322531378944, 804.2272601286495,
                       -27.49104557778628),
    ("jamba-v0.1-52b.l16", None): (-16.73486571999092, 810.4042837692687,
                                   -800.1499125145056),
    ("jamba-v0.1-52b.l16", "fp8"): (-17.023637723374122, 811.2174506965312,
                                    -806.0338826818042),
}


@pytest.mark.parametrize("key", list(PINNED_LOGITS), ids=str)
def test_the_smoke_references_give_the_same_logits(key):
    name, quant = key
    ref = {"dense": dense, "hybrid": hybrid}[_config(name)["reference"]]
    d = _dims(name, smoke=True)
    w = weights.Weights(d, 7, torch.device("cpu"), torch.bfloat16)
    toks = traffic.prompts(7, 0, 2, 16, d["vocab_size"], torch.device("cpu"))
    with torch.no_grad():
        lg = ref.serve_logits(d, w, toks, 4, 12, quant).double()
    pos = torch.arange(lg.numel(), dtype=torch.float64).view(lg.shape) % 97
    got = (float(lg.sum()), float(lg.abs().sum()), float((lg * pos).sum()))
    assert got == pytest.approx(PINNED_LOGITS[key], rel=1e-6, abs=1e-4)


def test_the_smoke_training_reference_gives_the_same_loss():
    d = _dims("yi-6b.stage8", smoke=True)
    params = {n: weights.make(n, s, 5, torch.device("cpu"), torch.float32)
              .requires_grad_(True) for n, s in weights.specs(d).items()}
    b = traffic.SyntheticTokens(d["vocab_size"], 5, 2, 16).batch_at(0)
    loss = dense.train_loss(d, params, torch.from_numpy(b["tokens"]).long(),
                            torch.from_numpy(b["labels"]).long())
    loss.backward()
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in params.values())))
    assert float(loss.detach()) == pytest.approx(5.587958812713623, rel=1e-6)
    assert norm == pytest.approx(2.1361836268860794, rel=1e-6)


# ---------------------------------------------------------------------------
# what port_config refuses
# ---------------------------------------------------------------------------

def _one_layer(cfg, **change):
    """cfg's pattern over its depth, with layer 3 changed."""
    return tuple(dataclasses.replace(cfg.pattern[l % len(cfg.pattern)],
                                     **(change if l == 3 else {}))
                 for l in range(cfg.n_layers))


def _shared_expert(cfg):
    from repro_torch.configs.base import MoESpec

    if cfg.moe is None:
        return dict(moe=MoESpec(n_experts=16, top_k=2, d_expert=1024,
                                n_shared=1))
    return dict(moe=dataclasses.replace(cfg.moe, n_shared=1))


# one change each to the port's configuration, on a file that states none
MUTATIONS = {
    "window": ("yi-6b", lambda cfg: dict(pattern=_one_layer(cfg, window=1024))),
    "qk_norm": ("yi-6b", lambda cfg: dict(qk_norm=True)),
    "shared_expert": ("yi-6b", _shared_expert),
    "shared_expert_jamba": ("jamba-v0.1-52b.l16", _shared_expert),
    "gelu_tanh": ("yi-6b", lambda cfg: dict(act="gelu_tanh")),
    "tied": ("yi-6b", lambda cfg: dict(tie_embeddings=True)),
    "softcap": ("yi-6b", lambda cfg: dict(logit_softcap=30.0)),
    "cross_attn": ("yi-6b",
                   lambda cfg: dict(pattern=_one_layer(cfg, cross_attn=True))),
}


@pytest.mark.parametrize("what", list(MUTATIONS))
def test_port_config_refuses_what_the_file_does_not_state(what):
    name, change = MUTATIONS[what]
    d = _dims(name)
    cfg = cells.port_config(d)
    with pytest.raises(SystemExit, match="differs from the configuration"):
        cells.check_port(d, dataclasses.replace(cfg, **change(cfg)))


def test_port_config_ignores_only_what_is_not_architecture():
    d = _dims("jamba-v0.1-52b.l16")
    cfg = cells.port_config(d)
    same = dataclasses.replace(
        cfg, name="other", attn_impl="naive", attn_block=64, remat="none",
        scan_layers=False,
        moe=dataclasses.replace(cfg.moe, router_aux_weight=0.0,
                                router_z_weight=0.0))
    assert cells.check_port(d, same) is same
    for change in (dict(rope_theta=1.0), dict(norm_eps=1e-5),
                   dict(dtype="float32"), dict(d_ff=1),
                   dict(moe=dataclasses.replace(cfg.moe, capacity_factor=2.0)),
                   dict(mamba=dataclasses.replace(cfg.mamba, dt_rank=8))):
        with pytest.raises(SystemExit):
            cells.check_port(d, dataclasses.replace(cfg, **change))


def test_layer_types_beside_jamba_period_keys_are_refused():
    c = dict(_config("jamba-v0.1-52b.l16"),
             layer_types=["full_attention"] * 16, sliding_window=8)
    with pytest.raises(SystemExit, match="period keys"):
        cells.dims(c)


def test_a_window_without_layer_types_is_refused():
    with pytest.raises(SystemExit, match="sliding_window"):
        cells.dims(dict(_config("yi-6b"), sliding_window=1024))


def test_fill_refuses_a_parameter_set_or_dtype_that_differs():
    from repro_torch.models.model import Model

    d = _dims("yi-6b", smoke=True)
    cfg = cells.port_config(d, smoke=True)
    with pytest.raises(SystemExit, match="parameters differ"):
        weights.fill(Model(dataclasses.replace(cfg, qk_norm=True),
                           torch.device("cpu")), d, seed=1)
    model = Model(cfg, torch.device("cpu"))
    p = model.get_parameter("layers.0.mixer.wq")
    p.data = p.data.half()
    with pytest.raises(SystemExit, match="layers.0.mixer.wq"):
        weights.fill(model, d, seed=1)


# ---------------------------------------------------------------------------
# the fixtures: the port's own architectures, joined by files alone
# ---------------------------------------------------------------------------

def test_gemma3_reads_its_windows_qk_norm_and_activation():
    d = _dims("gemma3-12b")
    assert d["windows"] == ([1024] * 5 + [None]) * 8
    assert d["layers"] == [("attn", "mlp")] * 48
    assert d["qk_norm"] is True and d["act"] == "gelu_tanh"
    assert d["head_dim"] == 256
    cfg = cells.port_config(d)
    assert cfg.head_dim == 256
    table = weights.specs(d)
    assert table["layers.0.mixer.q_norm"] == ((256,), "normal", 0.1)
    assert table["layers.0.mixer.wq"][0] == (3840, 16 * 256)


def test_deepseek_reads_its_shared_experts():
    d = _dims("deepseek-moe-16b")
    assert d["layers"] == [("attn", "moe")] * 28
    assert (d["n_experts"], d["top_k"], d["d_expert"]) == (64, 6, 1408)
    assert (d["n_shared"], d["d_shared"]) == (2, 2 * 1408)
    cells.port_config(d)
    table = weights.specs(d)
    assert table["layers.0.ffn.shared_wg"] == ((2048, 2816), "normal", 0.02)
    assert table["layers.0.ffn.shared_wo"] == ((2816, 2048), "fan_in", 1.0)
