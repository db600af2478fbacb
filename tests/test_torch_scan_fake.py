"""The selective scan's branch for fake tensors (the dry run's) and its
plain version under a tally.

* Under ``FakeTensorMode`` the forward returns empty tensors of the
  kernel's output shapes and dtypes: y (B, T, dI) in x's dtype, the final
  state (B, dI, N) f32, and, in training, the states the card saves for
  the backward, (B, n_chunks(T), dI, N) f32, which autograd keeps until
  the backward; the backward returns empty gradients of the inputs'
  shapes and dtypes. Each call adds the kernel's work
  (``cost.scan_work`` / ``cost.scan_bwd_work``) to the open tallies and
  counts one in ``fake_launches`` / ``fake_bwd_launches``; the real
  launch counts stay as they were.
* A real CPU tensor takes the plain version, and a tally counts the
  kernel's work in its place (``cost.stand_in``): the same FLOPs and
  bytes as a launch on the card, and none of the plain version's ops.
  A real CUDA tensor's side is
  ``tests/test_torch_kernels_gpu.py::test_a_real_cuda_tensor_never_takes_the_scans_fake_branch``.
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import cost, hlo
from repro_torch.kernels.mamba_scan import kernel
from repro_torch.kernels.mamba_scan.ops import SelectiveScan, selective_scan
from repro_torch.kernels.mamba_scan.ref import (selective_scan_bwd_ref,
                                                selective_scan_ref)

B, T, dI, N = 2, 40, 24, 4
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32)]


def _inputs(x_dtype, p_dtype, grad=False):
    gen = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen)
    args = [rn(B, T, dI).to(x_dtype),
            torch.nn.functional.softplus(rn(B, T, dI) - 2).to(p_dtype),
            -torch.exp(rn(dI, N) * 0.5), rn(B, T, N).to(p_dtype),
            rn(B, T, N).to(p_dtype), rn(dI)]
    return [a.requires_grad_(grad) for a in args]


def _counts():
    return (selective_scan.launches, selective_scan.bwd_launches,
            selective_scan.fake_launches, selective_scan.fake_bwd_launches)


def _work(x_dtype, p_dtype, chunks):
    flops, _ex2, nbytes = cost.scan_work(
        B, T, dI, N, x_dtype.itemsize, p_dtype.itemsize, chunks)
    return {"launches": 1, "flops": float(flops), "bytes": float(nbytes)}


def _bwd_work(x_dtype, p_dtype):
    flops, _ex2, nbytes = cost.scan_bwd_work(
        B, T, dI, N, x_dtype.itemsize, p_dtype.itemsize, kernel.n_chunks(T))
    return {"launches": 1, "flops": float(flops), "bytes": float(nbytes)}


@pytest.mark.parametrize("x_dtype,p_dtype", DTYPES)
def test_serving_forward_on_fake_tensors(x_dtype, p_dtype):
    before = _counts()
    with FakeTensorMode():
        args = _inputs(x_dtype, p_dtype)
        with cost.count_cost() as tally:
            y, h = selective_scan(*args, return_state=True)
    assert y.shape == (B, T, dI) and y.dtype == x_dtype
    assert h.shape == (B, dI, N) and h.dtype == torch.float32
    assert tally.kernels == {"selective_scan": _work(x_dtype, p_dtype, 0)}
    assert tally.flops == _work(x_dtype, p_dtype, 0)["flops"]
    a = before
    assert _counts() == (a[0], a[1], a[2] + 1, a[3])


@pytest.mark.parametrize("x_dtype,p_dtype", DTYPES)
def test_training_forward_and_backward_on_fake_tensors(x_dtype, p_dtype):
    before = _counts()
    saved = []
    with FakeTensorMode():
        args = _inputs(x_dtype, p_dtype, grad=True)
        with cost.count_cost() as tally, \
                torch.autograd.graph.saved_tensors_hooks(
                    lambda t: saved.append(tuple(t.shape)) or t,
                    lambda t: t):
            y, h = SelectiveScan.apply(*args)
        states = (B, kernel.n_chunks(T), dI, N)
        assert states in saved          # kept for the backward, as on a card
        assert y.shape == (B, T, dI) and y.dtype == x_dtype
        assert h.shape == (B, dI, N) and h.dtype == torch.float32
        with cost.count_cost() as bwd_tally:
            grads = torch.autograd.grad(y, args, torch.ones_like(y))
    for g, a in zip(grads, args):
        assert g.shape == a.shape and g.dtype == a.dtype
    chunks = kernel.n_chunks(T)
    assert tally.kernels == {"selective_scan": _work(x_dtype, p_dtype,
                                                     chunks)}
    assert bwd_tally.kernels == {"selective_scan_bwd": _bwd_work(x_dtype,
                                                                 p_dtype)}
    a = before
    assert _counts() == (a[0], a[1], a[2] + 1, a[3] + 1)


def test_the_saved_states_count_in_a_dry_runs_memory():
    """The training forward's saved states stay live after the call, so
    the recorder's peak holds them (a serving forward saves none)."""
    peaks = {}
    with FakeTensorMode():
        for train in (False, True):
            args = _inputs(torch.float32, torch.float32, grad=train)
            rec = hlo.Recorder(track_memory=True)
            with cost.tally(rec), rec:
                rec.recording.hold(args)
                out = (SelectiveScan.apply(*args) if train else
                       selective_scan(*args, return_state=True))
            peaks[train] = rec.recording.peak_bytes
            del out
    states = B * kernel.n_chunks(T) * dI * N * 4
    assert peaks[True] - peaks[False] == states


@pytest.mark.parametrize("x_dtype,p_dtype", DTYPES)
def test_a_real_cpu_tensor_takes_the_plain_version(x_dtype, p_dtype):
    args = _inputs(x_dtype, p_dtype)
    before = _counts()
    y, h = selective_scan(*args, return_state=True)
    want, want_h = selective_scan_ref(*args)
    assert torch.equal(y, want.to(x_dtype)) and torch.equal(h, want_h)
    with cost.count_cost() as tally:
        selective_scan(*args)
    # counted as the kernel it stands in for, its own ops not at all
    assert tally.kernels == {"selective_scan": _work(x_dtype, p_dtype, 0)}
    assert tally.flops == _work(x_dtype, p_dtype, 0)["flops"]
    assert tally.flops_by_op == {}
    assert _counts() == before


def test_a_real_cpu_backward_counts_the_kernels():
    """Training on the CPU: the forward counts the states the card would
    save, the backward the backward kernel; the gradients are the plain
    backward's."""
    args = _inputs(torch.float32, torch.float32, grad=True)
    before = _counts()
    with cost.count_cost() as tally:
        y, _h = SelectiveScan.apply(*args)
        dy = torch.ones_like(y)
        grads = torch.autograd.grad(y, args, dy)
    want = selective_scan_bwd_ref(*[a.detach() for a in args], dy)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert tally.kernels == {
        "selective_scan": _work(torch.float32, torch.float32,
                                kernel.n_chunks(T)),
        "selective_scan_bwd": _bwd_work(torch.float32, torch.float32)}
    assert tally.flops_by_op == {}
    assert _counts() == before
