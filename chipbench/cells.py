"""A cell's pieces, found by name: its entry of ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its limits (``limits/<cell>.json``).

:func:`dims` reads a configuration's sizes into the plain dict that the
weights, the references and the FLOP counts take; :func:`port_config`
builds the port's ``ModelConfig`` for it and refuses one whose sizes
differ from the file's.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

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


def _pattern(c: Dict[str, Any], n_layers: int) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer: attention every ``attn_layer_period``
    layers at ``attn_layer_offset`` and experts likewise (Jamba's keys);
    all attention and MLP without them."""
    out = []
    for l in range(n_layers):
        attn = ("attn_layer_period" not in c or
                l % c["attn_layer_period"] == c["attn_layer_offset"])
        moe = ("expert_layer_period" in c and
               l % c["expert_layer_period"] == c["expert_layer_offset"])
        out.append(("attn" if attn else "mamba", "moe" if moe else "mlp"))
    return out


def dims(config: Dict[str, Any], smoke: bool = False) -> Dict[str, Any]:
    """The sizes of a configuration file as a plain dict."""
    c = sized(config, smoke)
    E, H = c["hidden_size"], c["num_attention_heads"]
    d = {
        "name": c["name"], "arch": c["arch"], "reference": c["reference"],
        "dtype": c["torch_dtype"],
        "d_model": E, "n_heads": H, "n_kv_heads": c["num_key_value_heads"],
        "head_dim": c.get("head_dim", E // H),
        "d_ff": c["intermediate_size"], "vocab_size": c["vocab_size"],
        "padded_vocab": -(-c["vocab_size"] // 256) * 256,
        "n_layers": c["num_hidden_layers"],
        "layers": _pattern(c, c["num_hidden_layers"]),
        "rope_theta": c.get("rope_theta",
                            c.get("assumed", {}).get("rope_theta")),
        "norm_eps": c["rms_norm_eps"],
    }
    if "num_experts" in c:
        assumed = config.get("assumed", {})
        n = c["num_experts"]
        d.update(n_experts=n, padded_experts=-(-n // 16) * 16,
                 top_k=c["num_experts_per_tok"],
                 d_expert=c.get("expert_intermediate_size",
                                c["intermediate_size"]),
                 capacity_factor=assumed["moe_capacity_factor"],
                 token_group=assumed["moe_token_group"])
    if "mamba_d_state" in c:
        d.update(d_inner=c["mamba_expand"] * E, d_state=c["mamba_d_state"],
                 d_conv=c["mamba_d_conv"],
                 dt_rank=c.get("mamba_dt_rank", math.ceil(E / 16)))
    return d


def port_config(d: Dict[str, Any], smoke: bool = False):
    """The port's ``ModelConfig`` of ``d``: the port's architecture at
    the file's depth. Raises ``SystemExit`` where any size the file states
    differs from the port's."""
    from repro_torch.configs.archs import get_config

    cfg = get_config(d["arch"], "smoke" if smoke else "full")
    cfg = dataclasses.replace(cfg, n_layers=d["n_layers"])
    have = {
        "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "padded_vocab": cfg.padded_vocab_size,
        "layers": [(s.mixer, s.ffn) for s in
                   (cfg.pattern[l % len(cfg.pattern)]
                    for l in range(cfg.n_layers))],
        "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps,
        "dtype": cfg.dtype,
    }
    if cfg.moe is not None:
        have.update(n_experts=cfg.moe.n_experts,
                    padded_experts=cfg.padded_n_experts,
                    top_k=cfg.moe.top_k, d_expert=cfg.moe.d_expert,
                    capacity_factor=cfg.moe.capacity_factor)
    if cfg.mamba is not None:
        have.update(d_inner=cfg.mamba.expand * cfg.d_model,
                    d_state=cfg.mamba.d_state, d_conv=cfg.mamba.d_conv,
                    dt_rank=cfg.mamba.dt_rank_for(cfg.d_model))
    plain = (not cfg.qk_norm and cfg.act == "silu" and not cfg.tie_embeddings
             and cfg.n_codebooks == 1 and cfg.logit_softcap is None
             and cfg.input_mode == "tokens"
             and all(s.window is None and not s.cross_attn
                     for s in cfg.pattern)
             and (cfg.moe is None or cfg.moe.n_shared == 0))
    wrong = {k: (d.get(k), v) for k, v in have.items() if d.get(k) != v}
    if wrong or not plain:
        raise SystemExit(f"{d['name']}: the port's {cfg.name} differs from "
                         f"the configuration file: {wrong or 'its layers'}")
    return cfg
