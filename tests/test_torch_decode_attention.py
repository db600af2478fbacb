"""Decode attention's wrapper on the CPU: its plain branch, its fake
branch (the dry run's), its checks and its split count.

* A real CPU tensor takes ``naive_attention``, bit for bit what the
  decode path computed before the kernel, and a tally counts the kernel's
  work in its place (``cost.stand_in``).
* Under ``FakeTensorMode`` the call returns an empty output of the
  kernel's shape and dtype, counts ``fake_launches`` and leaves
  ``launches`` as it was; what the kernel does not take raises first.
* P.V runs in two bf16 halves of p (``csrc/decode_attn.cu``), which
  carry p far past one bf16 rounding. The kernel itself is held to the
  plain version on the card (``tests/test_torch_kernels_gpu.py``).
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.archs import get_config
from repro_torch.core import cost
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import naive_attention
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.train.step import make_decode_step, make_prefill_step


def _inputs(dtype=torch.float32, B=2, S=300, K=2, G=4, D=16, pos=250,
            seed=0):
    """q (B, 1, K, G, D), caches (B, S, K, D), a global layer's slots
    0..pos filled (past the cache, slot S - 1 holds pos) and pos 0-d."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, K, G, D), generator=gen).to(dtype)
    k, v = (torch.randn((B, S, K, D), generator=gen).to(dtype)
            for _ in range(2))
    pos_k = torch.full((S,), -1, dtype=torch.int32)
    n = min(pos, S - 1) + 1
    pos_k[:n] = torch.arange(n, dtype=torch.int32)
    if pos >= S - 1:
        pos_k[S - 1] = pos
    return q, k, v, pos_k, torch.tensor(pos, dtype=torch.int32)


def _ring(S=64, pos=150):
    """A windowed layer's ring after it wrapped."""
    return torch.tensor([max(p for p in range(pos + 1) if p % S == s)
                         for s in range(S)], dtype=torch.int32)


CASES = {
    "global": dict(),
    "first position": dict(pos=0),
    "clamped": dict(S=64, pos=70),
    "window": dict(S=64, window=48, ring=True),
    "cross": dict(S=50, cross=True),
}


def _case(name, dtype=torch.float32):
    c = dict(CASES[name])
    window, ring, cross = (c.pop(k, None) for k in ("window", "ring",
                                                    "cross"))
    q, k, v, pos_k, pos_q = _inputs(dtype, **c)
    if ring:
        pos_k, pos_q = _ring(k.shape[1]), torch.tensor(150, dtype=torch.int32)
    if cross:
        pos_k = torch.arange(k.shape[1], dtype=torch.int32)
        pos_q = torch.tensor(2 ** 30, dtype=torch.int32)
    return q, k, v, pos_k, pos_q, window


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES))
def test_the_plain_branch_is_naive_attention_bit_for_bit(name, dtype):
    q, k, v, pos_k, pos_q, window = _case(name, dtype)
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos_k, pos_q, window)
    want = naive_attention(q, k, v, pos_q.reshape(1), pos_k, causal=True,
                           window=window)
    assert torch.equal(got, want) and got.dtype == dtype
    assert decode_attention.launches == before


def test_a_tally_counts_the_plain_version_as_the_kernel():
    q, k, v, pos_k, pos_q, _ = _case("global")
    with cost.count_cost() as tally:
        decode_attention(q, k, v, pos_k, pos_q)
    flops, nbytes = cost.decode_attention_work(2, 300, 8, 2, 16, 4)
    assert tally.kernels == {"decode_attention": {
        "launches": 1, "flops": float(flops), "bytes": float(nbytes)}}
    assert tally.flops == flops and not tally.flops_by_op


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_tensors_take_the_fake_branch(dtype):
    launches, fake = decode_attention.launches, decode_attention.fake_launches
    with FakeTensorMode():
        q, k, v, pos_k, pos_q = _inputs(dtype, D=128, G=8)
        with cost.count_cost() as tally:
            out = decode_attention(q, k, v, pos_k, pos_q)
    assert out.shape == q.shape and out.dtype == dtype
    assert decode_attention.fake_launches == fake + 1
    assert decode_attention.launches == launches
    assert tally.kernels["decode_attention"]["launches"] == 1


@pytest.mark.parametrize("what", ["head_dim", "group", "dtype",
                                  "positions", "stride"])
def test_the_fake_branch_refuses_what_the_kernel_does_not_take(what):
    fake = decode_attention.fake_launches
    with FakeTensorMode():
        q, k, v, pos_k, pos_q = _inputs(
            torch.float16 if what == "dtype" else torch.bfloat16,
            D=32 if what == "head_dim" else 128,
            G=9 if what == "group" else 8, S=64, pos=40)
        if what == "positions":
            pos_k = pos_k.long()
        if what == "stride":        # slots 136 * 2 B apart, base 8 B off
            k = torch.zeros((2, 64, 2, 136), dtype=k.dtype)[..., 4:132]
        with pytest.raises(ValueError):
            decode_attention(q, k, v, pos_k, pos_q)
    assert decode_attention.fake_launches == fake


@pytest.mark.parametrize("what", ["rank", "two_queries", "cache", "pos_k",
                                  "pos_q", "window"])
def test_bad_shapes_raise_on_every_device(what):
    q, k, v, pos_k, pos_q = _inputs()
    window = 0 if what == "window" else None
    if what == "rank":
        q = q[:, 0]
    if what == "two_queries":
        q = torch.cat([q, q], dim=1)
    if what == "cache":
        v = v[:, :-1]
    if what == "pos_k":
        pos_k = pos_k[:-1]
    if what == "pos_q":
        pos_q = pos_q.reshape(1).repeat(2)
    with pytest.raises(ValueError):
        decode_attention(q, k, v, pos_k, pos_q, window)


@pytest.mark.parametrize("B,K,S,sms,want", [
    (32, 4, 1280, 132, 2),      # yi6b.serve.decode_b32: 256 blocks
    (4, 4, 4112, 132, 8),       # yi6b.serve.prefill_mix: 128 blocks
    (4, 8, 4112, 132, 8),       # jamba's attention layers
    (2, 4, 40, 132, 1),         # the smoke sizes: fewer slots than a split
    (1, 4, 10_000, 132, 8),     # capped by a cluster's 8 blocks
])
def test_the_split_count_comes_from_the_shapes(B, K, S, sms, want):
    assert kernel.n_splits(B, K, S, sms) == want


def test_two_bf16_halves_carry_p_far_past_bf16():
    """P.V in two bf16 halves: p to within 2**-16 of itself, where one
    bf16 rounding (the plain version's) leaves 2**-9."""
    p = torch.rand(10_000)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert float(((hi + lo - p).abs() / p).max()) < 2 ** -16
    assert float(((hi - p).abs() / p).max()) > 2 ** -10


def test_generate_reports_no_decode_attention_launch_on_the_cpu():
    model = Model(get_config("yi-6b", "smoke"),
                  torch.device("cpu")).init_weights(0)
    prompts = torch.randint(0, 100, (2, 8),
                            generator=torch.Generator().manual_seed(0))
    _, stats = serve.generate(model, prompts, 3)
    assert stats["decode_attention_launches"] == 0


def test_a_decode_step_counts_one_kernel_an_attention_layer():
    cfg = get_config("yi-6b", "smoke")
    model = Model(cfg, torch.device("cpu")).init_weights(0)
    prompts = torch.randint(0, 100, (2, 8),
                            generator=torch.Generator().manual_seed(0))
    caches = model.alloc_cache(2, 9)
    with torch.no_grad():
        make_prefill_step(cfg)(model, {"tokens": prompts}, caches)
        with cost.count_cost() as tally:
            make_decode_step(cfg)(model, caches, {"tokens": prompts[:, :1]},
                                  8)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    flops, nbytes = cost.decode_attention_work(2, 9, H, K, D, 2)
    assert tally.kernels["decode_attention"] == {
        "launches": cfg.n_layers, "flops": float(cfg.n_layers * flops),
        "bytes": float(cfg.n_layers * nbytes)}
