"""The gradient of the port's selective scan and of the mamba mixer's train
mode against the JAX package.

The JAX package has no backward kernel: it trains jamba by ``jax.grad``
through its jnp chunked scan (``repro.models.mamba.mamba_apply``). So the
port's plain backward (autograd through ``kernels/mamba_scan/ref.py``,
``selective_scan_bwd_ref``) is held to ``jax.vjp`` of the JAX reference
scan, and ``mamba_apply(mode="train")`` with its parameter and input
gradients to ``jax.grad`` of the JAX ``mamba_apply(mode="train")``, at T 40
and at T 200, where the JAX scan pads time to 256 inside its chunks. The
backward kernel's algorithm (a reverse-time walk over sub-tiles of 16
steps, each sub-tile's a_t and h_t recomputed from the state the forward
saved at its start, a_t h_{t-1} formed as h_t - dt x B, per-block partial
sums of dB and dC over 64 channels) is written out in numpy here and held
to the plain backward, and its reduce-scatter of dB and dC over a warp's
channels is modelled lane by lane and held to plain sums; the card holds
the CUDA kernel to the plain backward (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` phase 28). Inputs are made with numpy from a seed, f32.
Bound: max|err| / max|ref| below 1e-4, as ``check_gradients``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import selective_scan_reference
from repro.models import mamba as jax_mamba
from repro_torch.core.cost import scan_bwd_work, scan_work
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.mamba_scan import kernel
from repro_torch.kernels.mamba_scan.ops import SelectiveScan, selective_scan
from repro_torch.kernels.mamba_scan.ref import (selective_scan_bwd_ref,
                                                selective_scan_ref)
from repro_torch.models import mamba
from test_torch_mamba import (configs, hidden, mixer_params, scan_inputs,
                              to_jax, to_torch)

CPU = torch.device("cpu")
GRAD_TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dBc", "dCc", "dD")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the scan's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,dI,N", [(2, 40, 64, 4), (1, 77, 48, 8),
                                      (2, 100, 96, 16)])
def test_plain_backward_matches_jax_vjp(B, T, dI, N):
    arrays = scan_inputs(B, T, dI, N, seed=T)
    dy = cotangent((B, T, dI), seed=N)
    got = selective_scan_bwd_ref(*to_torch(arrays), torch.from_numpy(dy))
    _, vjp = jax.vjp(selective_scan_reference, *to_jax(arrays))
    want = vjp(jnp.asarray(dy))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert rel(g.numpy(), w) < GRAD_TOL, (name, rel(g.numpy(), w))


def test_plain_backward_is_autograd_of_the_plain_scan():
    args = [t.requires_grad_(True) for t in to_torch(scan_inputs(2, 50, 32,
                                                                 8))]
    dy = torch.from_numpy(cotangent((2, 50, 32), seed=1))
    y, _ = selective_scan_ref(*args)
    want = torch.autograd.grad(y, args, dy)
    got = selective_scan_bwd_ref(*args, dy)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


def test_plain_backward_keeps_the_inputs_dtypes():
    x, dt, A, Bc, Cc, D = to_torch(scan_inputs(1, 20, 16, 4),
                                   torch.bfloat16)
    dy = torch.ones_like(x)
    got = selective_scan_bwd_ref(x, dt, A, Bc, Cc, D, dy)
    assert [g.dtype for g in got] == [torch.bfloat16] * 2 + [
        torch.float32] + [torch.bfloat16] * 2 + [torch.float32]


def kernel_algorithm(x, dt, A, Bc, Cc, D, dy, every=kernel.SAVE_EVERY,
                     channels=kernel.CHANNELS):
    """The backward kernel's algorithm in numpy, f32: the forward's states
    after every ``every`` steps and at T, then each sub-tile of ``every``
    steps, last first, recomputed from the state before it (a_t and h_t
    kept) and walked in reverse with a_t h_{t-1} formed as h_t - dt x B;
    ddt as sum A g a h_{t-1} + x sum g B; dB and dC as partial sums over
    blocks of ``channels`` channels, dA and dD over batch rows, each summed
    over its leading axis at the end."""
    B, T, dI = x.shape
    n = -(-T // every)
    h = np.zeros((B, dI, A.shape[1]), np.float32)
    chunks = []
    for t in range(T):
        h = np.exp(dt[:, t, :, None] * A) * h + (
            dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :]
        if t % every == every - 1 or t == T - 1:
            chunks.append(h)
    assert len(chunks) == n
    dx, ddt = np.zeros_like(x), np.zeros_like(dt)
    blocks = -(-dI // channels)
    dB_part = np.zeros((blocks, B, T, A.shape[1]), np.float32)
    dC_part = np.zeros_like(dB_part)
    dA_part = np.zeros((B,) + A.shape, np.float32)
    g = np.zeros_like(h)
    a_next = np.zeros_like(h)
    for q in reversed(range(n)):
        steps = range(q * every, min(T, (q + 1) * every))
        h = chunks[q - 1] if q else np.zeros_like(h)
        a_s, h_s = [], []
        for t in steps:
            a_s.append(np.exp(dt[:, t, :, None] * A))
            h = a_s[-1] * h + ((dt[:, t] * x[:, t])[..., None]
                               * Bc[:, t, None, :])
            h_s.append(h)
        for s in reversed(range(len(steps))):
            t = steps[s]
            dtx = (dt[:, t] * x[:, t])[..., None]
            g = dy[:, t, :, None] * Cc[:, t, None, :] + a_next * g
            p = g * (h_s[s] - dtx * Bc[:, t, None, :])
            sum_dx = (g * Bc[:, t, None, :]).sum(-1)
            dx[:, t] = sum_dx * dt[:, t] + D * dy[:, t]
            ddt[:, t] = (A * p).sum(-1) + x[:, t] * sum_dx
            dA_part += dt[:, t, :, None] * p
            vb = g * dtx
            vc = dy[:, t, :, None] * h_s[s]
            for k in range(blocks):
                cols = slice(k * channels, (k + 1) * channels)
                dB_part[k, :, t] = vb[:, cols].sum(1)
                dC_part[k, :, t] = vc[:, cols].sum(1)
            a_next = a_s[s]
    return (dx, ddt, dA_part.sum(0), dB_part.sum(0), dC_part.sum(0),
            (dy * x).sum((0, 1)))


@pytest.mark.parametrize("B,T,dI,N", [(2, 70, 80, 4), (1, 33, 130, 16)])
def test_kernel_algorithm_matches_plain_backward(B, T, dI, N):
    arrays = scan_inputs(B, T, dI, N, seed=B + T)
    dy = cotangent((B, T, dI), seed=3)
    got = kernel_algorithm(*arrays, dy)
    want = selective_scan_bwd_ref(*to_torch(arrays), torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == tuple(w.shape), name
        assert rel(g, w.numpy()) < GRAD_TOL, (name, rel(g, w.numpy()))


def channel_sum_model(vals, L):
    """``channel_sum`` of ``selective_scan_bwd.cu`` over one warp in numpy:
    ``vals`` (32 lanes, 8) holds each lane's dB then dC of its states
    4j .. 4j+3, lane = channel * L + j. Lane bits 4, 3 and 2 each halve the
    values a lane keeps (the lane with the bit set keeps the upper half and
    adds its partner's), then lane bits 1 and 0, where they name channels
    (L < 4), add the partner's one value. Yields, after each level, each
    lane's kept values and their indices into the eight."""
    lanes = np.arange(32)
    keep = vals.astype(np.float32).copy()
    idx = np.tile(np.arange(8), (32, 1))
    for bit in (16, 8, 4):
        half = keep.shape[1] // 2
        hi = (lanes & bit) != 0
        lo_v, hi_v = keep[:, :half], keep[:, half:]
        mine = np.where(hi[:, None], hi_v, lo_v)
        sent = np.where(hi[:, None], lo_v, hi_v)
        keep = mine + sent[lanes ^ bit]
        idx = np.where(hi[:, None], idx[:, half:], idx[:, :half])
        yield bit, keep, idx
    for bit in (2, 1)[:{4: 0, 2: 1, 1: 2}[L]]:
        keep = keep + keep[lanes ^ bit]
        yield bit, keep, idx


@pytest.mark.parametrize("N", [4, 8, 16])
def test_reduce_scatter_sums_each_value_over_the_warps_channels(N):
    L = N // 4
    vals = np.random.default_rng(N).standard_normal((32, 8)).astype(
        np.float32)
    lanes = np.arange(32)
    channel_bits = 31 ^ (L - 1)
    reduced = 0
    shuffles = 0
    for bit, keep, idx in channel_sum_model(vals, L):
        reduced |= bit
        shuffles += keep.shape[1]
        # each lane's values: the plain sum over the lanes that differ from
        # it only in the channel bits reduced so far
        for lane in lanes:
            group = lanes[(lanes & ~reduced) == (lane & ~reduced)]
            want = vals[group][:, idx[lane]].sum(0)
            np.testing.assert_allclose(keep[lane], want, rtol=1e-6,
                                       atol=1e-6)
    assert reduced == channel_bits and keep.shape[1] == 1
    assert shuffles == {16: 7, 8: 8, 4: 9}[N]
    # the kernel's writers: one lane for each of the 2N (dB or dC, n),
    # holding the sum over the warp's 32 / L channels
    m = lanes >> 2
    assert np.array_equal(idx[:, 0], m)
    writers = lanes[(lanes & (3 ^ (L - 1))) == 0]
    j = writers & (L - 1)
    red_at = (m[writers] >> 2) * N + 4 * j + (m[writers] & 3)
    assert sorted(red_at) == list(range(2 * N))
    for lane, at in zip(writers, red_at):
        same_j = lanes[(lanes & (L - 1)) == (lane & (L - 1))]
        k = 4 * (at >= N) + at % 4           # its index into the eight
        np.testing.assert_allclose(keep[lane, 0], vals[same_j, k].sum(),
                                   rtol=1e-6, atol=1e-6)


def test_autograd_function_on_the_cpu_is_the_plain_backward():
    arrays = scan_inputs(2, 45, 24, 8, seed=5)
    dy = torch.from_numpy(cotangent((2, 45, 24), seed=6))
    args = [t.requires_grad_(True) for t in to_torch(arrays)]
    y, h = SelectiveScan.apply(*args)
    assert not h.requires_grad
    got = torch.autograd.grad(y, args, dy)
    y_ref, h_ref = selective_scan_ref(*to_torch(arrays))
    assert torch.equal(y.detach(), y_ref) and torch.equal(h, h_ref)
    want = selective_scan_bwd_ref(*to_torch(arrays), dy)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


def test_scan_goes_through_the_function_only_for_a_gradient():
    x, dt, A, Bc, Cc, D = to_torch(scan_inputs(1, 10, 8, 4))
    assert selective_scan(x, dt, A, Bc, Cc, D).grad_fn is None
    dt.requires_grad_(True)
    y = selective_scan(x, dt, A, Bc, Cc, D)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    with torch.no_grad():
        assert selective_scan(x, dt, A, Bc, Cc, D).grad_fn is None
    y.sum().backward()
    assert dt.grad is not None and dt.grad.shape == dt.shape


def test_cpu_scans_count_no_kernel_launch():
    before = (selective_scan.launches, selective_scan.bwd_launches)
    args = [t.requires_grad_(True) for t in to_torch(scan_inputs(1, 12, 8,
                                                                 4))]
    selective_scan(*args).sum().backward()
    assert (selective_scan.launches, selective_scan.bwd_launches) == before


def test_backward_work_counts_each_byte_once():
    B, T, dI, N = 4, 1024, 8192, 16
    n = kernel.n_chunks(T)
    flops, exps, nbytes = scan_bwd_work(B, T, dI, N, 2, 4, n)
    assert kernel.SAVE_EVERY == 16 and kernel.TILE % kernel.SAVE_EVERY == 0
    assert n == 64 and kernel.n_chunks(1000) == 63
    assert exps == B * T * dI * N and flops == B * T * dI * (22 * N + 6)
    # x, dy, dx (bf16), dt, ddt (f32); B, C, dB, dC; A, D, dA, dD; the
    # saved states
    assert nbytes == (B * T * dI * 14 + 4 * B * T * N * 4
                      + 2 * (dI * N * 4 + dI * 4) + B * n * dI * N * 4)
    # the forward that saves the states writes them once more
    assert (scan_work(B, T, dI, N, 2, 4, n)[2] - scan_work(B, T, dI, N, 2,
                                                           4)[2]
            == B * n * dI * N * 4 == 134_217_728)


def test_the_scan_sources_share_a_header(tmp_path, monkeypatch):
    names = ("selective_scan", "selective_scan_bwd")
    src = kbuild.SOURCES["selective_scan"].parent
    for name in names:
        assert '#include "scan.cuh"' in kbuild.SOURCES[name].read_text()
    before = {n: kbuild.library_path(n) for n in names}
    dst = tmp_path / "csrc"
    dst.mkdir()
    for path in src.iterdir():
        (dst / path.name).write_bytes(path.read_bytes())
    for name in names:
        monkeypatch.setitem(kbuild.SOURCES, name,
                            dst / kbuild.SOURCES[name].name)
    assert {n: kbuild.library_path(n).name for n in names} == {
        n: p.name for n, p in before.items()}
    (dst / "scan.cuh").write_text((dst / "scan.cuh").read_text() + "\n")
    for name in names:
        assert kbuild.library_path(name).name != before[name].name


# ---------------------------------------------------------------------------
# mamba_apply(mode="train")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [40, 200])
def test_train_mode_and_its_gradients_match_jax(T):
    jcfg, tcfg = configs()
    params = mixer_params(jcfg, seed=T)
    x = hidden(2, T, jcfg.d_model, seed=T + 1)
    w = cotangent((2, T, jcfg.d_model), seed=T + 2)

    def jax_loss(p, xx):
        out, cache = jax_mamba.mamba_apply(p, xx, jcfg, mode="train")
        assert cache is None
        return (out * w).sum(), out

    (_, j_out), (j_gp, j_gx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = mamba.mamba_apply(tp, tx, tcfg, None, mode="train")
    out.backward(torch.from_numpy(w))
    assert rel(out.detach().numpy(), j_out) < GRAD_TOL
    assert rel(tx.grad.numpy(), j_gx) < GRAD_TOL
    for name, p in tp.items():
        assert rel(p.grad.numpy(), j_gp[name]) < GRAD_TOL, (
            name, rel(p.grad.numpy(), j_gp[name]))


def test_train_mode_is_prefill_without_a_cache():
    _, tcfg = configs()
    params = {k: torch.from_numpy(v)
              for k, v in mixer_params(tcfg, seed=9).items()}
    x = torch.from_numpy(hidden(2, 36, tcfg.d_model, seed=10))
    cache = mamba.alloc_cache(tcfg, 2, CPU)
    want = mamba.mamba_apply(params, x, tcfg, cache, mode="prefill")
    got = mamba.mamba_apply(params, x, tcfg, None, mode="train")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="train, prefill or decode"):
        mamba.mamba_apply(params, x, tcfg, None, mode="generate")
