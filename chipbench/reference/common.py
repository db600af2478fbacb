"""Plain PyTorch pieces of the references, in f32, and the parameters
they read.

Nothing here imports the program. The arithmetic follows the published
models as the configuration files state them, with the port's
conventions noted there under ``departures``: RMSNorm scales by
(1 + weight), the embedding rows by sqrt(d_model), RoPE splits each head
in halves. TF32 is switched off by :func:`exact_matmuls`, so a float32
product is a float32 product.

What every family shares, as ``d`` (:func:`chipbench.cells.dims`) states
it: an attention layer's window (``d["windows"]``), qk-norm
(``d["qk_norm"]``, where the family reads it), the FFN's activation
(``d["act"]``). The parameter tables (``*_specs``) give each parameter
its shape, initializer and scale (:mod:`chipbench.weights`).

``quant="fp8"`` gives the control: every linear layer's input (per row)
and weight (per output column) rounded to float8 e4m3 with a scale of
its own, the product then taken in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0

# a parameter's (shape, initializer, scale); initializers: normal (std =
# scale), fan_in (std = scale / sqrt(shape[-2])), around (scale + normal
# 0.1), log_range (log 1..N along the last axis)
Spec = Tuple[Tuple[int, ...], str, float]

# the activations by their name in ``d["act"]``
ACTS = {"silu": F.silu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}


def exact_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled by its largest magnitude
    along ``dim``, and back in f32; its gradient passes straight
    through."""
    scale = (x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
             / FP8_MAX)
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str] = None
           ) -> torch.Tensor:
    """x @ w; with ``quant="fp8"`` both rounded first (:func:`fp8`)."""
    if quant == "fp8":
        return fp8(x, -1) @ fp8(w, -2)
    if quant is not None:
        raise ValueError(f"quant {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..T-1 on x (B, T, H, D), the halves of each head
    rotated as pairs."""
    T, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 512, window: Optional[int] = None
                     ) -> torch.Tensor:
    """Causal softmax attention, q (B, T, H, D) against k, v (B, T, K, D)
    (query head h reads key head h // (H / K)), in blocks of queries of
    one row at a time; with a ``window`` a query at t sees only keys
    t - window + 1 .. t. Returns (B, T, H, D)."""
    B, T, H, D = q.shape
    K = k.shape[2]
    G = H // K
    out = []
    for b in range(B):
        rows = []
        for s in range(0, T, block):
            e = min(s + block, T)
            lo = 0 if window is None else max(0, s - window + 1)
            qb = q[b, s:e].reshape(e - s, K, G, D)
            sc = torch.einsum("tkgd,skd->kgts", qb, k[b, lo:e]) / math.sqrt(D)
            kpos = torch.arange(lo, e, device=q.device)[None, :]
            qpos = torch.arange(s, e, device=q.device)[:, None]
            mask = kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
            rows.append(torch.einsum("kgts,skd->tkgd", p, v[b, lo:e])
                        .reshape(e - s, H, D))
        out.append(torch.cat(rows))
    return torch.stack(out)


def attention_layer(d: dict, w, p: str, h: torch.Tensor,
                    quant: Optional[str] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """The self-attention sublayer of weights ``p + "mixer.*"`` on the
    normed input h (B, T, E), over the last ``window`` positions where
    one is given; qk-norm (each head's q and k RMS-normed before RoPE)
    where ``d["qk_norm"]``."""
    B, T, _ = h.shape
    H, K, D = d["n_heads"], d["n_kv_heads"], d["head_dim"]
    q = linear(h, w(p + "mixer.wq"), quant).view(B, T, H, D)
    k = linear(h, w(p + "mixer.wk"), quant).view(B, T, K, D)
    v = linear(h, w(p + "mixer.wv"), quant).view(B, T, K, D)
    if d.get("qk_norm"):
        q = rms_norm(q, w(p + "mixer.q_norm"), d["norm_eps"])
        k = rms_norm(k, w(p + "mixer.k_norm"), d["norm_eps"])
    q, k = rope(q, d["rope_theta"]), rope(k, d["rope_theta"])
    o = causal_attention(q, k, v, window=window)
    return linear(o.reshape(B, T, H * D), w(p + "mixer.wo"), quant)


def mlp(h: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
        wo: torch.Tensor, quant: Optional[str] = None, act: str = "silu"
        ) -> torch.Tensor:
    """The gated FFN: act(h wg) * (h wi), then wo."""
    return linear(ACTS[act](linear(h, wg, quant)) * linear(h, wi, quant), wo,
                  quant)


def embed(d: dict, w, tokens: torch.Tensor) -> torch.Tensor:
    return w("embed")[tokens] * math.sqrt(d["d_model"])


def logits(d: dict, w, x: torch.Tensor, quant: Optional[str] = None
           ) -> torch.Tensor:
    """Final norm and lm_head over the last axis of x; the vocab's pad
    columns are left out."""
    h = rms_norm(x, w("final_norm"), d["norm_eps"])
    return linear(h, w("lm_head"), quant)[..., :d["vocab_size"]]


# ---------------------------------------------------------------------------
# parameter tables: name -> (shape, initializer, scale), in the order the
# program's parameters are drawn and summed (chipbench.weights)
# ---------------------------------------------------------------------------

def top_specs(d: dict) -> Dict[str, Spec]:
    """The embedding, the final norm and the lm_head."""
    if d["tie_embeddings"]:
        raise SystemExit(f"{d['name']}: tied embeddings: no reference reads "
                         f"the lm_head from the embedding yet")
    E, V = d["d_model"], d["padded_vocab"]
    return {
        "embed": ((V, E), "normal", 0.02),
        "final_norm": ((E,), "normal", 0.1),
        "lm_head": ((E, V), "normal", 0.02),
    }


def norm_specs(d: dict, p: str) -> Dict[str, Spec]:
    """A layer's two pre-norms."""
    E = d["d_model"]
    return {p + "norm_mixer": ((E,), "normal", 0.1),
            p + "norm_ffn": ((E,), "normal", 0.1)}


def attention_specs(d: dict, p: str) -> Dict[str, Spec]:
    """An attention mixer's projections (and qk-norm scales)."""
    E, H, K, D = d["d_model"], d["n_heads"], d["n_kv_heads"], d["head_dim"]
    out = {
        p + "mixer.wq": ((E, H * D), "normal", 0.02),
        p + "mixer.wk": ((E, K * D), "normal", 0.02),
        p + "mixer.wv": ((E, K * D), "normal", 0.02),
        p + "mixer.wo": ((H * D, E), "fan_in", 1.0),
    }
    if d.get("qk_norm"):
        out[p + "mixer.q_norm"] = ((D,), "normal", 0.1)
        out[p + "mixer.k_norm"] = ((D,), "normal", 0.1)
    return out


def mlp_specs(d: dict, prefix: str, width: int) -> Dict[str, Spec]:
    """A gated FFN of ``width`` under ``prefix`` (``wg``, ``wi``, ``wo``)."""
    E = d["d_model"]
    return {prefix + "wg": ((E, width), "normal", 0.02),
            prefix + "wi": ((E, width), "normal", 0.02),
            prefix + "wo": ((width, E), "fan_in", 1.0)}
