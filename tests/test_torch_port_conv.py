"""The stride-1 blocks' channels-last convolution (``ops/kernels/conv_kernels.py``)
on the CPU: which path each block takes (``conv_route``), the three passes'
plain versions against ``F.conv1d`` under autograd, and ``Wav2Letter.forward``
with the kernel's data flow (its autograd function, run here on the plain
versions) against the channels-first ``F.conv1d`` flow, forward and every
gradient in float64, with the head reading the last block's output as it
lies.  The kernels themselves run on the card (``chip_smoke.py::check_conv``).
"""

import pytest
import torch
import torch.nn.functional as F

import torch_asg_tpu_torch.models.wav2letter as w2l
from torch_asg_tpu_torch.models import Wav2Letter
from torch_asg_tpu_torch.ops.kernels import conv_kernels as ck

CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")
CFG = dict(num_labels=12, channels=16, depth=2, head_channels=24,
           frontend_kernel=11, frontend_stride=2, kernel=7)
FEATURES = 8


@pytest.mark.parametrize("device,dtype,stride,kernel,sharded,route", [
    (CUDA, torch.float32, 1, 7, False, "kernel"),       # the mid and wide blocks on the card
    (CUDA, torch.float32, 1, 1, False, "kernel"),
    (CUDA, torch.float32, 2, 48, False, "conv1d"),      # the strided front end
    (CUDA, torch.float32, 2, 7, False, "conv1d"),
    (CUDA, torch.float32, 1, 6, False, "kernel"),       # even width: unequal SAME pads
    (CUDA, torch.float64, 1, 7, False, "conv1d"),
    (CUDA, torch.bfloat16, 1, 7, False, "conv1d"),
    (CPU, torch.float32, 1, 7, False, "conv1d"),
    (CPU, torch.float64, 1, 7, False, "conv1d"),
    (CUDA, torch.float32, 1, 7, True, "sharded"),       # a DTensor weight
    (CPU, torch.float64, 2, 11, True, "sharded"),
])
def test_conv_route(device, dtype, stride, kernel, sharded, route):
    assert w2l.conv_route(device, dtype, stride, kernel, sharded) == route


def _reference(x, weight, bias):
    """relu(conv1d(x) + bias) with SAME pads on channels-last ``x``."""
    pads = w2l.same_padding(x.shape[1], weight.shape[-1], 1)
    return F.relu(F.conv1d(F.pad(x.transpose(1, 2), pads), weight, bias)).transpose(1, 2)


@pytest.mark.parametrize("b,t,cin,cout,k", [
    (2, 13, 5, 6, 7), (1, 9, 4, 3, 3), (3, 1, 5, 4, 7), (2, 6, 3, 5, 7), (2, 7, 3, 5, 7),
    (2, 10, 6, 4, 1),
    # even widths: SAME pads (K - 1) // 2 on the left, K // 2 on the right
    (2, 13, 5, 6, 6), (1, 9, 4, 3, 2), (3, 1, 5, 4, 4), (2, 5, 3, 5, 8), (2, 8, 3, 5, 8),
    (2, 11, 6, 4, 14),
])
def test_passes_match_conv1d(b, t, cin, cout, k):
    """Forward, the masked gradient's dgrad and wgrad, and the bias gradient
    of the autograd function (plain versions) against ``F.conv1d``'s
    autograd, in float64; T below, at and above the width, odd and even."""
    gen = torch.Generator().manual_seed(b * 1000 + t)
    x = torch.randn(b, t, cin, dtype=torch.float64, generator=gen, requires_grad=True)
    weight = torch.randn(cout, cin, k, dtype=torch.float64, generator=gen, requires_grad=True)
    bias = torch.randn(cout, dtype=torch.float64, generator=gen, requires_grad=True)
    up = torch.randn(b, t, cout, dtype=torch.float64, generator=gen)
    got = ck.conv_relu(x, weight, bias)
    want = _reference(x, weight, bias)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert (got == 0).any() and (got > 0).any()  # the mask is exercised
    grads = torch.autograd.grad((got * up).sum(), (x, weight, bias))
    wants = torch.autograd.grad((want * up).sum(), (x, weight, bias))
    for g, w in zip(grads, wants, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    with torch.no_grad():
        torch.testing.assert_close(ck.conv_relu(x, weight, bias), want)


def _reference_bias(x, weight, bias):
    """conv1d(x) + bias with SAME pads on channels-last ``x``, no ReLU."""
    pads = w2l.same_padding(x.shape[1], weight.shape[-1], 1)
    return F.conv1d(F.pad(x.transpose(1, 2), pads), weight, bias).transpose(1, 2)


@pytest.mark.parametrize("b,t,cin,cout,k", [
    (2, 13, 5, 6, 7), (1, 9, 4, 3, 4), (3, 1, 5, 4, 6), (2, 3, 3, 5, 5), (2, 4, 3, 5, 9),
    (2, 12, 6, 8, 13), (2, 12, 6, 8, 14),
])
def test_bias_only_block_matches_conv1d(b, t, cin, cout, k):
    """``conv_bias``, the gated blocks' convolution: forward without a ReLU
    and its unmasked backward (input, weight and bias gradients) against
    ``F.conv1d``'s autograd in float64, at odd and even widths, T below,
    at and above the width; a negative output passes unclipped."""
    gen = torch.Generator().manual_seed(b * 100 + t * 10 + k)
    x = torch.randn(b, t, cin, dtype=torch.float64, generator=gen, requires_grad=True)
    weight = torch.randn(cout, cin, k, dtype=torch.float64, generator=gen, requires_grad=True)
    bias = torch.randn(cout, dtype=torch.float64, generator=gen, requires_grad=True)
    up = torch.randn(b, t, cout, dtype=torch.float64, generator=gen)
    got = ck.conv_bias(x, weight, bias)
    want = _reference_bias(x, weight, bias)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert (got < 0).any()
    grads = torch.autograd.grad((got * up).sum(), (x, weight, bias))
    wants = torch.autograd.grad((want * up).sum(), (x, weight, bias))
    for g, w in zip(grads, wants, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    with torch.no_grad():
        torch.testing.assert_close(ck.conv_bias(x, weight, bias), want)
    w_only = torch.autograd.grad((ck.conv_bias(x.detach(), weight, None) * up).sum(), weight)
    want_w = torch.autograd.grad((_reference_bias(x.detach(), weight, None) * up).sum(), weight)
    torch.testing.assert_close(w_only[0], want_w[0], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k,left,right", [
    (1, 0, 0), (2, 0, 1), (7, 3, 3), (14, 6, 7), (29, 14, 14)])
def test_same_pads(k, left, right):
    assert ck.same_pads(k) == (left, right) == w2l.same_padding(100, k, 1)


def test_passes_take_no_bias():
    """A block without a bias (``nn.Conv1d(..., bias=False)``): forward and
    gradients."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    weight = torch.randn(5, 4, 5, dtype=torch.float64, generator=gen, requires_grad=True)
    got, want = ck.conv_relu(x, weight, None), _reference(x, weight, None)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    up = torch.randn(got.shape, dtype=torch.float64, generator=gen)
    for g, w in zip(torch.autograd.grad((got * up).sum(), (x, weight)),
                    torch.autograd.grad((want * up).sum(), (x, weight)), strict=True):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cout,kd,m_total,want", [
    (250, 1750, 64_000, 9),    # the mid stack: 28 tiles, 252 blocks on 264 slots
    (2000, 1750, 64_000, 8),   # the wide block: 224 tiles, 1792 blocks in 7 waves
    (256, 1792, 64_000, 9),
    (250, 1750, 100, 2),       # one wave at most: the fuller of 1 and 2
])
def test_wgrad_splits(cout, kd, m_total, want):
    tiles = -(-cout // 128) * -(-kd // 128)  # csrc/conv.cu's 128 x 128 tiles
    got = ck.wgrad_splits(tiles, m_total, 264)
    assert got == want
    assert -(-m_total // got) <= ck.WGRAD_SLICE_ROWS


def _models(dtype=torch.float64, dropout=0.0):
    torch.manual_seed(0)
    model = Wav2Letter(in_features=FEATURES, device="cpu", dtype=dtype, dropout=dropout, **CFG)
    return model


def _kernel_route(device, dtype, stride, kernel, sharded):
    """Every stride-1 block on the kernel's path, on the CPU too (its
    autograd function over the plain versions)."""
    return "kernel" if stride == 1 and not sharded else "conv1d"


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setattr(w2l, "conv_route", _kernel_route)


def _run(model, feats, up, train=False, seed=None):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    model.zero_grad(set_to_none=True)
    em = model(feats, train=train, generator=gen)
    (em * up).sum().backward()
    return em.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("length", [17, 20, 2])
def test_channels_last_flow_matches_conv1d_flow(length, monkeypatch):
    """Emissions and every parameter's gradient of the kernel's data flow
    equal the channels-first ``F.conv1d`` flow's in float64."""
    model = _models()
    gen = torch.Generator().manual_seed(length)
    feats = torch.randn(3, length, FEATURES, dtype=torch.float64, generator=gen)
    up = torch.randn(-(-length // 2), 3, CFG["num_labels"], dtype=torch.float64, generator=gen)
    want_em, want = _run(model, feats, up)
    calls = []
    real = ck.conv_relu
    monkeypatch.setattr(w2l, "conv_relu", lambda *a: calls.append(a[0].shape) or real(*a))
    monkeypatch.setattr(w2l, "conv_route", _kernel_route)
    got_em, got = _run(model, feats, up)
    assert len(calls) == CFG["depth"] + 1
    torch.testing.assert_close(got_em, want_em, rtol=1e-11, atol=1e-11)
    assert got.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-10, atol=1e-10, msg=name)


def test_channels_last_flow_keeps_dropout_masks(monkeypatch):
    """With dropout, the kernel's flow draws the masks the ``F.conv1d``
    flow draws from the same generator."""
    model = _models(dropout=0.3)
    feats = torch.randn(2, 12, FEATURES, dtype=torch.float64)
    up = torch.randn(6, 2, CFG["num_labels"], dtype=torch.float64)
    want_em, want = _run(model, feats, up, train=True, seed=5)
    monkeypatch.setattr(w2l, "conv_route", _kernel_route)
    got_em, got = _run(model, feats, up, train=True, seed=5)
    assert (got_em != _run(model, feats, up, train=True, seed=6)[0]).any()
    torch.testing.assert_close(got_em, want_em, rtol=1e-11, atol=1e-11)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-10, atol=1e-10, msg=name)


def test_head_reads_the_wide_block_output_in_place(kernel_route):
    """The head takes the wide block's (B, T', C) output itself: the same
    storage, contiguous, no transposed copy."""
    model = _models()
    seen = {}
    model.blocks[-1].register_forward_hook(lambda m, i, o: seen.setdefault("wide", o))
    model.proj.register_forward_pre_hook(lambda m, i: seen.setdefault("head", i[0]))
    model(torch.randn(2, 10, FEATURES, dtype=torch.float64))
    wide, head = seen["wide"], seen["head"]
    assert head.shape == (2, 5, CFG["head_channels"])
    assert head.is_contiguous()
    assert head.data_ptr() == wide.data_ptr()
    assert head.untyped_storage().data_ptr() == wide.untyped_storage().data_ptr()


def test_the_stride_one_blocks_are_conv_spans(kernel_route):
    """Under a profiler each forward call on the kernel's path is one
    ``asg.conv`` span: depth + 1 a forward."""
    model = _models()
    feats = torch.randn(2, 10, FEATURES, dtype=torch.float64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(feats).sum().backward()
    names = [e.name for e in prof.events()]
    assert names.count("asg.conv") == CFG["depth"] + 1


