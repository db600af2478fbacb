"""MODEL_FLOPS: the useful-math floor for each (arch x shape) cell.

6*N*D for training (2*N*D forward, x3 with backward), with N = *active*
matmul params (MoE counts top-k + shared experts only, embedding-table
lookups excluded), plus the sequence-mixing terms that are not param
matmuls: causal attention at T^2/2 (the optimal causal schedule),
sliding-window at T*W, mLSTM chunk products, mamba scan elementwise ops.

A copy of ``repro.launch.flops``: the port imports nothing of the JAX
package. Keep the two in step.
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import active_param_count


def matmul_param_count(cfg: ModelConfig) -> int:
    """Active params engaged in per-token matmuls: no embedding-table
    gather, no padded vocab tail of the lm_head."""
    n = active_param_count(cfg)
    Vp = cfg.padded_vocab_size
    if cfg.input_mode != "frames":
        n -= Vp * cfg.d_model                      # embedding gather
    n -= cfg.n_codebooks * (Vp - cfg.vocab_size) * cfg.d_model
    return n


def _attn_layer_counts(cfg: ModelConfig):
    full, windowed, cross = 0, 0, 0
    for s in cfg.pattern:
        if s.mixer == "attn":
            if s.window is None:
                full += 1
            else:
                windowed += 1
        if s.cross_attn:
            cross += 1
    g = cfg.n_groups
    return full * g, windowed * g, cross * g


def mixer_flops_token(cfg: ModelConfig, ctx: int, window_ctx: int) -> float:
    """Sequence-mixing flops for ONE token attending over `ctx` history."""
    H, D = cfg.n_heads, cfg.head_dim
    n_full, n_win, n_cross = _attn_layer_counts(cfg)
    f = 0.0
    f += n_full * 4.0 * H * D * ctx
    f += n_win * 4.0 * H * D * window_ctx
    f += n_cross * 4.0 * H * D * max(cfg.encoder_len, 0)
    # state-space / recurrent mixers, per layer
    f_state = 0.0
    for s in cfg.pattern:
        if s.mixer == "mamba" and cfg.mamba:
            dI = cfg.mamba.expand * cfg.d_model
            f_state += 10.0 * dI * cfg.mamba.d_state
        if s.mixer == "mlstm" and cfg.xlstm:
            dI = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
            Dh = dI // cfg.n_heads
            q = cfg.xlstm.chunk
            f_state += 4.0 * cfg.n_heads * Dh * min(q, max(ctx, 1))
            f_state += 4.0 * dI * Dh                   # inter-chunk state read
        if s.mixer == "slstm":
            pass                                       # r_gates already in params
    f += f_state * cfg.n_groups
    return f


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global useful flops for one step of this cell."""
    Np = matmul_param_count(cfg)
    B = shape.global_batch
    if shape.kind == "train":
        T = shape.seq_len
        tokens = B * T
        # mean causal context = T/2; windowed context = min(W, T/2-ish) ~ W
        mix = sum(
            mixer_flops_token(cfg, ctx=T // 2, window_ctx=1024)
            for _ in range(1)
        ) * tokens
        return 6.0 * Np * tokens + 3.0 * mix
    if shape.kind == "prefill":
        T = shape.seq_len
        tokens = B * T
        mix = mixer_flops_token(cfg, ctx=T // 2, window_ctx=1024) * tokens
        return 2.0 * Np * tokens + mix
    # decode: one token against a seq_len-deep cache
    ctx = shape.seq_len
    mix = mixer_flops_token(cfg, ctx=ctx, window_ctx=1024) * B
    return 2.0 * Np * B + mix
