"""A cell's pieces, found by name: its entry of ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its limits (``limits/<cell>.json``).

:func:`dims` reads a configuration's sizes into the plain dict that the
weights, the references and the FLOP counts take: the keys every family
shares here, and those of its reference family (``"reference"`` names a
module of ``chipbench/reference/``) by that module's ``read``.
:func:`port_config` builds the port's ``ModelConfig`` for it and refuses
one whose architecture differs from what the file states
(:func:`check_port`).

A configuration joins the benchmark by files of its own: its
``configs/<name>.json``, its family's ``reference/<family>.py`` (where
no family there computes it: ``read``, ``port_fields``, ``specs`` and
``serve_logits``, and ``train_loss`` to train), its traffic, limits and
metric files, and its entries in ``BENCHMARK.json``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Dict[str, Any]:
    """The cell ``name``: its ``workloads`` entry, with ``config_file``
    (the configuration's file, as ``BENCHMARK.json`` names it),
    ``traffic_file`` and ``limits_file`` read in."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    out = dict(entry)
    out["config_file"] = load_json(ROOT / cfg["file"])
    out["traffic_file"] = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    out["limits_file"] = load_json(HERE / "limits" / f"{name}.json")
    out["bench"] = bench
    return out


def sized(entry: Dict[str, Any], smoke: bool) -> Dict[str, Any]:
    """A configuration's or traffic mix's keys, with its ``smoke`` keys
    over them for a run at smoke size (the CPU tests)."""
    out = {k: v for k, v in entry.items() if k != "smoke"}
    if smoke:
        out.update(entry.get("smoke", {}))
    return out


# the period keys of Jamba's pattern; a file gives them or ``layer_types``
PERIOD_KEYS = ("attn_layer_period", "attn_layer_offset",
               "expert_layer_period", "expert_layer_offset")
# ``layer_types`` entries: attention over every position, or a window
LAYER_TYPES = {"full_attention": False, "sliding_attention": True}
# ``hidden_act`` (Hugging Face's names) -> the references' name (``ACTS``)
FILE_ACTS = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh"}
# the port's ``act`` -> what it computes, in the references' names (the
# port's ``gelu`` is the tanh approximation, as ``jax.nn.gelu`` is)
PORT_ACTS = {"gelu": "gelu_tanh"}


def family(d: Dict[str, Any]) -> ModuleType:
    """The reference module of ``d``'s family (``reference/<name>.py``)."""
    return importlib.import_module(f"{__package__}.reference.{d['reference']}")


def _mixers(c: Dict[str, Any], n: int) -> Tuple[List[str], List[Optional[int]]]:
    """Each layer's mixer and window: attention every ``attn_layer_period``
    layers at ``attn_layer_offset`` and mamba between (Jamba's keys); or
    ``layer_types``, ``sliding_attention`` over the last
    ``sliding_window`` positions; or global attention throughout."""
    if "layer_types" in c and any(k in c for k in PERIOD_KEYS):
        raise SystemExit(f"{c['name']}: layer_types and Jamba's period keys "
                         f"both state the pattern")
    if "attn_layer_period" in c:
        return (["attn" if l % c["attn_layer_period"] == c["attn_layer_offset"]
                 else "mamba" for l in range(n)], [None] * n)
    if "layer_types" in c:
        types = c["layer_types"]
        if len(types) != n or not set(types) <= set(LAYER_TYPES):
            raise SystemExit(f"{c['name']}: layer_types must give each of the "
                             f"{n} layers one of {sorted(LAYER_TYPES)}")
        return (["attn"] * n, [c["sliding_window"] if LAYER_TYPES[t] else None
                               for t in types])
    if "sliding_window" in c:
        raise SystemExit(f"{c['name']}: sliding_window without layer_types")
    return ["attn"] * n, [None] * n


def _ffns(c: Dict[str, Any], n: int) -> List[str]:
    """Each layer's FFN: experts every ``expert_layer_period`` layers at
    ``expert_layer_offset`` (Jamba's keys); or by ``mlp_layer_types``
    (``dense`` or ``sparse``); or, where experts are stated, experts after
    the first ``num_dense_layers`` (default 0); else an MLP throughout."""
    if "expert_layer_period" in c:
        return ["moe" if l % c["expert_layer_period"] == c["expert_layer_offset"]
                else "mlp" for l in range(n)]
    if "mlp_layer_types" in c:
        kinds = {"dense": "mlp", "sparse": "moe"}
        types = c["mlp_layer_types"]
        if len(types) != n or not set(types) <= set(kinds):
            raise SystemExit(f"{c['name']}: mlp_layer_types must give each of "
                             f"the {n} layers dense or sparse")
        return [kinds[t] for t in types]
    if "num_experts" in c:
        dense = c.get("num_dense_layers", 0)
        return ["mlp" if l < dense else "moe" for l in range(n)]
    return ["mlp"] * n


def dims(config: Dict[str, Any], smoke: bool = False) -> Dict[str, Any]:
    """The sizes of a configuration file as a plain dict. Every key has a
    default where the file may leave it out: global attention, an MLP and
    ``silu`` in every layer, untied embeddings, no shared experts, no
    extra matmul parameters."""
    c = sized(config, smoke)
    E, H, n = c["hidden_size"], c["num_attention_heads"], c["num_hidden_layers"]
    mixers, windows = _mixers(c, n)
    act = c.get("hidden_act", "silu")
    if act not in FILE_ACTS:
        raise SystemExit(f"{c['name']}: hidden_act {act!r} is none of "
                         f"{sorted(FILE_ACTS)}")
    d = {
        "name": c["name"], "arch": c["arch"], "reference": c["reference"],
        "dtype": c["torch_dtype"],
        "d_model": E, "n_heads": H, "n_kv_heads": c["num_key_value_heads"],
        "head_dim": c.get("head_dim", E // H),
        "d_ff": c["intermediate_size"], "vocab_size": c["vocab_size"],
        "padded_vocab": -(-c["vocab_size"] // 256) * 256,
        "n_layers": n,
        "layers": list(zip(mixers, _ffns(c, n))),
        "rope_theta": c.get("rope_theta",
                            c.get("assumed", {}).get("rope_theta")),
        "norm_eps": c["rms_norm_eps"],
        "windows": windows,
        "act": FILE_ACTS[act],
        "tie_embeddings": bool(c.get("tie_word_embeddings", False)),
        # matmul parameters a token meets beyond attention, mamba and the
        # FFN, by layer (an output gate); a family's ``read`` sets them
        "extra_params": [0] * n,
    }
    if "num_experts" in c:
        assumed = config.get("assumed", {})
        n_exp = c["num_experts"]
        d_expert = c.get("moe_intermediate_size",
                         c.get("expert_intermediate_size",
                               c["intermediate_size"]))
        n_shared = c.get("num_shared_experts", 0)
        d.update(n_experts=n_exp, padded_experts=-(-n_exp // 16) * 16,
                 top_k=c["num_experts_per_tok"], d_expert=d_expert,
                 capacity_factor=assumed["moe_capacity_factor"],
                 token_group=assumed["moe_token_group"],
                 n_shared=n_shared,
                 d_shared=c.get("shared_expert_intermediate_size",
                                n_shared * d_expert))
    family(d).read(c, d)
    return d


# fields of the port's ``ModelConfig`` that are not architecture, and
# are not compared: labels (``name``, ``family``); how attention and the
# layers are computed, not what (``attn_impl``, ``attn_block``, ``remat``,
# ``scan_layers``); the router's weights in the training loss, which no
# reference's loss has (``moe.router_aux_weight``, ``moe.router_z_weight``).
# ``n_layers`` is the file's; ``pattern`` is compared layer by layer.
NOT_ARCH = frozenset({"name", "family", "attn_impl", "attn_block", "remat",
                      "scan_layers", "n_layers", "moe.router_aux_weight",
                      "moe.router_z_weight"})


def port_view(cfg) -> Dict[str, Any]:
    """The architecture of a port ``ModelConfig`` (or of its class's
    defaults, with ``cfg`` None) as plain values, named as :func:`implied`
    names them: ``head_dim`` for ``d_head``, ``act`` by what it computes,
    ``layers`` (each layer's ``LayerSpec`` fields, ``pattern`` repeated
    to ``n_layers``), ``moe`` with its ``shared_width``, ``mamba`` with
    ``d_inner`` and ``dt_rank`` as the port derives them."""
    from repro_torch.configs.base import ModelConfig

    out: Dict[str, Any] = {}
    for f in dataclasses.fields(ModelConfig):
        if f.name in NOT_ARCH:
            continue
        if cfg is None:
            if f.default is dataclasses.MISSING:
                continue
            v = f.default
        else:
            v = getattr(cfg, f.name)
        if f.name == "pattern":
            if cfg is not None:
                out["layers"] = [dataclasses.asdict(v[l % len(v)])
                                 for l in range(cfg.n_layers)]
        elif f.name == "d_head":
            if cfg is not None:
                out["head_dim"] = cfg.head_dim
        elif f.name == "act":
            out["act"] = PORT_ACTS.get(v, v)
        elif f.name == "moe" and v is not None:
            m = {k: x for k, x in dataclasses.asdict(v).items()
                 if f"moe.{k}" not in NOT_ARCH}
            out["moe"] = dict(m, shared_width=v.n_shared * v.d_expert)
        elif f.name == "mamba" and v is not None:
            out["mamba"] = {"d_inner": v.expand * cfg.d_model,
                            "d_state": v.d_state, "d_conv": v.d_conv,
                            "dt_rank": v.dt_rank_for(cfg.d_model)}
        elif dataclasses.is_dataclass(v):
            out[f.name] = dataclasses.asdict(v)
        else:
            out[f.name] = v
    return out


def implied(d: Dict[str, Any]) -> Dict[str, Any]:
    """The port's architecture that the file states (:func:`port_view`'s
    names): the class's defaults, the keys every family shares over them,
    and the family's ``port_fields`` over those."""
    from repro_torch.configs.base import LayerSpec

    want = port_view(None)
    want.update(
        d_model=d["d_model"], n_heads=d["n_heads"], n_kv_heads=d["n_kv_heads"],
        head_dim=d["head_dim"], d_ff=d["d_ff"], vocab_size=d["vocab_size"],
        rope_theta=d["rope_theta"], norm_eps=d["norm_eps"], act=d["act"],
        tie_embeddings=d["tie_embeddings"], dtype=d["dtype"],
        layers=[dict(dataclasses.asdict(LayerSpec()), mixer=m, ffn=f, window=w)
                for (m, f), w in zip(d["layers"], d["windows"])])
    if "n_experts" in d:
        want["moe"] = {"n_experts": d["n_experts"], "top_k": d["top_k"],
                       "d_expert": d["d_expert"], "n_shared": d["n_shared"],
                       "capacity_factor": d["capacity_factor"],
                       "shared_width": d["d_shared"]}
    fields = family(d).port_fields(d)
    for layer, over in zip(want["layers"], fields.pop("layers", [])):
        layer.update(over)
    for key in ("moe", "mamba"):
        if key in fields and want.get(key) is not None:
            fields[key] = dict(want[key], **fields[key])
    want.update(fields)
    return want


def check_port(d: Dict[str, Any], cfg):
    """``cfg`` where its architecture is the file's (:func:`implied`);
    else ``SystemExit`` naming every field that differs, as (file, port)."""
    want, have = implied(d), port_view(cfg)
    wrong = {k: (want.get(k, "unstated"), v) for k, v in have.items()
             if k != "layers" and want.get(k, "unstated") != v}
    if len(want["layers"]) != len(have["layers"]):
        wrong["layers"] = (len(want["layers"]), len(have["layers"]))
    wrong.update({f"layers.{l}": (w, h) for l, (w, h) in
                  enumerate(zip(want["layers"], have["layers"])) if w != h})
    if wrong:
        raise SystemExit(f"{d['name']}: the port's {cfg.name} differs from "
                         f"the configuration file: {wrong}")
    return cfg


def port_config(d: Dict[str, Any], smoke: bool = False):
    """The port's ``ModelConfig`` of ``d``: the port's architecture
    ``d["arch"]`` at the file's depth, held to the file by
    :func:`check_port`. Raises ``SystemExit`` where the port has no such
    architecture or it differs from the file."""
    from repro_torch.configs.archs import ARCHS, get_config

    if d["arch"] not in ARCHS:
        raise SystemExit(f"{d['name']}: the port has no architecture "
                         f"{d['arch']!r} (it has {sorted(ARCHS)})")
    cfg = get_config(d["arch"], "smoke" if smoke else "full")
    return check_port(d, dataclasses.replace(cfg, n_layers=d["n_layers"]))
