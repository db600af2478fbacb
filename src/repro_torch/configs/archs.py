"""The 10 assigned architectures, exact configs from the brief, plus
reduced "smoke" presets (same family, tiny dims) for CPU tests.

Sources are noted per config; all values follow the assignment block
verbatim (layer counts, widths, heads, kv heads, d_ff, vocab, MoE shape).

A copy of ``repro.configs.archs``: the port imports nothing of the JAX package.
Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import LayerSpec, MambaSpec, MoESpec, ModelConfig, XLSTMSpec

A = LayerSpec


def jamba_v0_1_52b() -> ModelConfig:
    # [arXiv:2403.19887] 32L, d=4096, 32H GQA kv=8, d_ff=14336, vocab 65536,
    # MoE 16e top-2; attn:mamba 1:7 (1 attention layer per period-8 block),
    # MoE every other layer.
    pattern = tuple(
        A(mixer=("attn" if i == 4 else "mamba"),
          ffn=("moe" if i % 2 == 1 else "mlp"))
        for i in range(8)
    )
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536,
        pattern=pattern,
        moe=MoESpec(n_experts=16, top_k=2, d_expert=14336),
        mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    )


def llama_3_2_vision_11b() -> ModelConfig:
    # [hf:meta-llama/Llama-3.2-11B-Vision] 40L, d=4096, 32H GQA kv=8,
    # d_ff=14336, vocab 128256; gated cross-attention every 5th layer.
    # Vision frontend is a stub: input_specs() provides patch embeddings.
    pattern = tuple(
        A(mixer="attn", ffn="mlp", cross_attn=(i == 4)) for i in range(5)
    )
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
        pattern=pattern, rope_theta=500000.0,
        input_mode="tokens+image", encoder_len=4096,
    )


def qwen3_32b() -> ModelConfig:
    # [hf:Qwen/Qwen3-*] 64L, d=5120, 64H GQA kv=8, d_ff=25600, vocab 151936,
    # qk-norm, head_dim=128.
    return ModelConfig(
        name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=64, n_kv_heads=8, d_ff=25600, vocab_size=151936,
        d_head=128, qk_norm=True, rope_theta=1000000.0,
    )


def minicpm_2b() -> ModelConfig:
    # [arXiv:2404.06395] 40L, d=2304, 36H (kv=36, MHA), d_ff=5760,
    # vocab 122753; llama-like arch, trained with the WSD schedule
    # (wired in repro.optim.adamw schedule="wsd").
    return ModelConfig(
        name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
        n_heads=36, n_kv_heads=36, d_ff=5760, vocab_size=122753,
    )


def yi_6b() -> ModelConfig:
    # [arXiv:2403.04652] 32L, d=4096, 32H GQA kv=4, d_ff=11008, vocab 64000.
    return ModelConfig(
        name="yi-6b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=11008, vocab_size=64000,
        rope_theta=5000000.0,
    )


def gemma3_12b() -> ModelConfig:
    # [hf:google/gemma-3-*] 48L, d=3840, 16H GQA kv=8, d_ff=15360,
    # vocab 262144; 5 local (sliding window 1024) : 1 global.
    pattern = tuple(
        A(mixer="attn", ffn="mlp", window=(1024 if i < 5 else None))
        for i in range(6)
    )
    return ModelConfig(
        name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
        n_heads=16, n_kv_heads=8, d_ff=15360, vocab_size=262144,
        d_head=256, pattern=pattern, qk_norm=True, act="gelu_tanh",
        logit_softcap=None, rope_theta=1000000.0,
    )


def musicgen_large() -> ModelConfig:
    # [arXiv:2306.05284] 48L, d=2048, 32H (kv=32), d_ff=8192, vocab 2048;
    # decoder-only over EnCodec tokens, 4 codebooks (delay pattern).
    # Audio frontend is a stub: input_specs() provides frame embeddings.
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048,
        input_mode="frames", n_codebooks=4, act="gelu",
    )


def granite_moe_3b_a800m() -> ModelConfig:
    # [hf:ibm-granite/granite-3.0-3b-a800m] 32L, d=1536, 24H GQA kv=8,
    # fine-grained MoE: 40 experts top-8, d_expert=512.
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
        n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155,
        pattern=(A(mixer="attn", ffn="moe"),),
        moe=MoESpec(n_experts=40, top_k=8, d_expert=512),
    )


def deepseek_moe_16b() -> ModelConfig:
    # [arXiv:2401.06066] 28L, d=2048, 16H (kv=16), d_ff=1408 per expert,
    # vocab 102400; 2 shared + 64 routed experts, top-6, fine-grained.
    # First layer is dense in the original; we follow the assigned spec
    # (MoE everywhere) for the cell definition.
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400,
        pattern=(A(mixer="attn", ffn="moe"),),
        moe=MoESpec(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    )


def xlstm_125m() -> ModelConfig:
    # [arXiv:2405.04517] 12L, d=768, 4H, vocab 50304; alternating
    # mLSTM/sLSTM blocks (d_ff=0: feed-forward lives inside the blocks).
    pattern = (A(mixer="mlstm", ffn="none"), A(mixer="slstm", ffn="none"))
    return ModelConfig(
        name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
        pattern=pattern, xlstm=XLSTMSpec(),
    )


ARCHS = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "qwen3-32b": qwen3_32b,
    "minicpm-2b": minicpm_2b,
    "yi-6b": yi_6b,
    "gemma3-12b": gemma3_12b,
    "musicgen-large": musicgen_large,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "deepseek-moe-16b": deepseek_moe_16b,
    "xlstm-125m": xlstm_125m,
}


def _shrink(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    plen = len(cfg.pattern)
    changes: Dict = dict(
        n_layers=plen,                       # one scan group
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, cfg.n_kv_heads),
        d_head=16,
        d_ff=min(cfg.d_ff, 128) if cfg.d_ff else 0,
        vocab_size=256,
        encoder_len=32 if cfg.encoder_len else 0,
        attn_block=32,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(8, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k), d_expert=32)
    if cfg.mamba is not None:
        changes["mamba"] = dataclasses.replace(cfg.mamba, d_state=4)
    if cfg.xlstm is not None:
        changes["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=16)
    return dataclasses.replace(cfg, **changes)


def get_config(name: str, preset: str = "full") -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    cfg = ARCHS[name]()
    if preset == "smoke":
        cfg = _shrink(cfg)
    return cfg
