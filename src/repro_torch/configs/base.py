"""Model / run configuration schema.

A model is a stack of layers described by a repeating ``pattern`` of
:class:`LayerSpec` (one scan *group*); ``n_layers`` must be a multiple of
the pattern length. The model scans over ``n_layers // len(pattern)``
groups, which keeps HLO size (and compile time) independent of depth.

A copy of ``repro.configs.base``: the port imports nothing of the JAX package.
Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None   # default ceil(d_model/16)

    def dt_rank_for(self, d_model: int) -> int:
        return self.dt_rank or max(1, math.ceil(d_model / 16))


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_kernel: int = 4
    chunk: int = 256               # chunked-parallel mLSTM block size


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One sublayer position inside the repeating pattern."""
    mixer: str = "attn"            # attn | mamba | mlstm | slstm | none
    ffn: str = "mlp"               # mlp | moe | none
    window: Optional[int] = None   # sliding-window size (attn only; None=global)
    cross_attn: bool = False       # extra cross-attention sublayer (vlm)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    d_head: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    xlstm: Optional[XLSTMSpec] = None
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    # modality frontends (stubs): inputs are precomputed embeddings
    input_mode: str = "tokens"     # tokens | frames (audio) | tokens+image (vlm)
    n_codebooks: int = 1           # audio heads (musicgen: 4)
    encoder_len: int = 0           # vlm: number of visual embedding positions
    logit_softcap: Optional[float] = None
    attn_impl: str = "blockwise"   # blockwise | naive | pallas
    attn_block: int = 512          # blockwise attention kv-block
    remat: str = "full"            # none | dots | full  (scan-group remat policy)
    scan_layers: bool = True
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256 so embed/lm_head shard over the
        model axis (TP-frameworks' standard trick; pad logits are masked)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def padded_n_experts(self) -> int:
        """Experts padded to a multiple of 16 for EP; pad experts are dead
        (router logits masked to -inf, so they never receive tokens)."""
        if self.moe is None:
            return 0
        return -(-self.moe.n_experts // 16) * 16

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        return self.n_layers // len(self.pattern)

    @property
    def uses_attention(self) -> bool:
        return any(s.mixer == "attn" or s.cross_attn for s in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no *global* full-attention layer blocks 500k contexts.

        Sliding-window attention layers are fine (KV bounded by window);
        mamba/mlstm/slstm are state-based."""
        for s in self.pattern:
            if s.mixer == "attn" and s.window is None and not _is_hybrid_ok(self):
                return False
        return True


def _is_hybrid_ok(cfg: "ModelConfig") -> bool:
    # hybrid archs (jamba) keep a few full-attention layers; with 1:7
    # interleave the KV cache at 500k stays manageable, so the assigned
    # long_500k cell runs for hybrid/ssm families per the brief.
    return cfg.family in ("hybrid", "ssm")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which of the four cells apply to an architecture (long_500k only for
    sub-quadratic archs, per the brief)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("hybrid", "ssm"):
        names.append("long_500k")
    return tuple(names)
