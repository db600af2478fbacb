"""Which flash-attention kernel a launch takes, and the checks made before it.

The dtype picks the variant: bfloat16 runs the forward, dq and dk/dv on the
tensor cores (``wgmma``), float32 on the scalar f32 kernels. The wgmma
variants copy 16-byte chunks, so their wrappers raise
``ValueError`` on a base address or stride that is not a multiple of 16
bytes, before any build or launch; that is testable here, on the CPU.
Launches are counted by variant beside the existing counters
(``flash_attention.launches_by_variant``), from the C entry's report of the
kernel it launched, not from the dtype; a CPU tensor counts none.
"""
import pytest
import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import kernel, ops

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("name,dtype,want", [
    ("fwd", BF16, "wgmma"), ("fwd", F32, "scalar"),
    ("dkv", BF16, "wgmma"), ("dkv", F32, "scalar"),
    ("dq", BF16, "wgmma"), ("dq", F32, "scalar"),
])
def test_variant_by_dtype(name, dtype, want):
    assert kernel.variant(name, dtype) == want


def test_variant_refuses_other_dtypes():
    with pytest.raises(ValueError):
        kernel.variant("fwd", torch.float16)


def test_counters_name_every_variant():
    assert set(ops.flash_attention.launches_by_variant) == {
        "fwd/wgmma", "fwd/scalar", "dq/wgmma", "dq/scalar", "dkv/wgmma",
        "dkv/scalar"}


def test_ops_and_kernel_share_one_variant_count():
    assert ops.flash_attention.launches_by_variant is kernel.launches_by_variant


def _entry(rc, code):
    """A stand-in for a C entry: writes ``code`` to its last argument,
    *launched, and returns ``rc``."""
    def entry(*args):
        args[-1]._obj.value = code
        return rc
    entry.__name__ = "stand_in"
    return entry


@pytest.mark.parametrize("name,code,key", [
    ("fwd", 0, "fwd/scalar"), ("fwd", 1, "fwd/wgmma"),
    ("dkv", 0, "dkv/scalar"), ("dkv", 1, "dkv/wgmma"), ("dq", 0, "dq/scalar"),
    ("dq", 1, "dq/wgmma"),
])
def test_launch_counts_the_kernel_the_entry_reports(monkeypatch, name, code,
                                                   key):
    counts = dict.fromkeys(kernel.launches_by_variant, 0)
    monkeypatch.setattr(kernel, "launches_by_variant", counts)
    kernel._launch(name, _entry(0, code), 1, 2)
    assert counts == {**dict.fromkeys(counts, 0), key: 1}


def test_failed_launch_raises_and_counts_nothing(monkeypatch):
    counts = dict.fromkeys(kernel.launches_by_variant, 0)
    monkeypatch.setattr(kernel, "launches_by_variant", counts)
    with pytest.raises(RuntimeError, match="stand_in launch failed"):
        kernel._launch("fwd", _entry(1, 1))
    assert not any(counts.values())


def _model_layout(B=2, T=40, H=4, K=2, D=32, dtype=BF16):
    return (torch.zeros(B, T, H, D, dtype=dtype),
            torch.zeros(B, T, K, D, dtype=dtype),
            torch.zeros(B, T, K, D, dtype=dtype))


def _shifted(shape, dtype=BF16):
    """A tensor of ``shape`` whose base address is one element past a
    16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _padded_rows(B, T, H, D, pad, dtype=BF16):
    """(B,T,H,D) with ``pad`` extra elements between positions."""
    base = torch.zeros(B * T * (H * D + pad), dtype=dtype)
    return base.as_strided((B, T, H, D), (T * (H * D + pad), H * D + pad, D, 1))


def test_alignment_accepts_the_model_layout():
    q, k, v = _model_layout()
    kernel.check_aligned("t", q, k, v)
    # a projection's output viewed per head, and a slice of heads of it
    x = torch.zeros(2, 40, 6 * 32, dtype=BF16)
    kernel.check_aligned("t", x.view(2, 40, 6, 32)[:, :, 2:4])


def test_alignment_ignores_strides_of_length_one_dimensions():
    x = torch.zeros(64, dtype=BF16).as_strided((1, 2, 1, 32), (3, 32, 5, 1))
    kernel.check_aligned("t", x)


@pytest.mark.parametrize("make", [
    lambda: _shifted((2, 40, 4, 32)),
    lambda: _padded_rows(2, 40, 4, 32, pad=4),    # 8-byte position stride
    lambda: torch.zeros(2, 40, 4 * 32 + 4, dtype=BF16)[..., :128].unflatten(
        -1, (4, 32)),                               # 264-byte position stride
])
def test_alignment_refuses_misaligned_tensors(make):
    with pytest.raises(ValueError, match="16-byte"):
        kernel.check_aligned("t", make())


@pytest.mark.parametrize("fn,which", [
    ("flash_fwd", "q"), ("flash_fwd", "k"), ("flash_fwd", "v"),
    ("flash_bwd_dq", "q"), ("flash_bwd_dq", "k"), ("flash_bwd_dq", "v"),
    ("flash_bwd_dq", "do"),
    ("flash_bwd_dkv", "q"), ("flash_bwd_dkv", "k"), ("flash_bwd_dkv", "v"),
    ("flash_bwd_dkv", "do"),
])
def test_wrappers_check_alignment_before_any_launch(tmp_path, monkeypatch,
                                                    fn, which):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    q, k, v = _model_layout()
    t = {"q": q, "k": k, "v": v, "do": torch.zeros_like(q)}
    t[which] = _shifted(tuple(t[which].shape))
    rows = torch.zeros(2, 4, 40)
    args = ((t["q"], t["k"], t["v"]) if fn == "flash_fwd" else
            (t["q"], t["k"], t["v"], t["do"], rows, rows))
    with pytest.raises(ValueError, match="16-byte"):
        getattr(kernel, fn)(*args)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("fn", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_f32_takes_no_alignment_check(tmp_path, monkeypatch, fn):
    """The scalar f32 kernels load element by element: a misaligned f32
    tensor gets past the alignment check to the device check."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    q = _shifted((2, 40, 4, 32), F32)
    _, k, v = _model_layout(dtype=F32)
    rows = torch.zeros(2, 4, 40)
    args = (q, k, v) if fn == "flash_fwd" else (q, k, v, q, rows, rows)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(kernel, fn)(*args)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cpu_tensors_count_no_variant(dtype):
    q, k, v = _model_layout(dtype=dtype)
    before = dict(ops.flash_attention.launches_by_variant)
    out, lse = ops.flash_attention(q, k, v)
    ops.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(q))
    assert ops.flash_attention.launches_by_variant == before
    assert all(n == 0 for n in before.values())


def test_serve_stats_count_prefill_launches_by_variant():
    from repro_torch.launch import serve

    _, stats = serve.main(["--device", "cpu", "--batch", "2",
                           "--prompt-len", "8", "--gen", "2"])
    assert stats["prefill_launches_by_variant"] == {
        k: 0 for k in ops.flash_attention.launches_by_variant}


def test_train_stats_count_launches_by_variant_per_step():
    from repro_torch.launch import train

    _, stats = train.main(["--device", "cpu", "--preset", "smoke",
                           "--steps", "2", "--batch", "2", "--seq", "32"])
    assert stats["launches_by_variant"] == [
        {k: 0 for k in ops.flash_attention.launches_by_variant}] * 2
