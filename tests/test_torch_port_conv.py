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
from torch_asg_tpu_torch.ops.kernels import common as kcommon
from torch_asg_tpu_torch.ops.kernels import conv_kernels as ck
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES

CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")
# csrc/conv.cu's tilings as conv_tiling lists them, and an H100's SMs
TILINGS = (ck.Tiling(128, 256, 8, 1), ck.Tiling(128, 128, 8, 2))
SMS = 132
PASSES = ("conv_fwd", "conv_dgrad", "conv_wgrad")
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


@pytest.mark.parametrize("cout,kd,m_total,want", [
    (250, 1750, 64_000, 9),      # the mid stack: 14 tiles, 126 blocks on 132 slots
    (2000, 1750, 64_000, 8),     # the wide block: 112 tiles, 896 blocks in 7 waves
    (1816, 23954, 32_000, 4),    # gated layer 17: 1410 tiles, 5640 blocks
    (532, 3872, 32_000, 8),      # gated layer 4: 80 tiles, 640 blocks
    (1130, 12336, 32_000, 4),    # gated layer 12: 441 tiles, 1764 blocks
])
def test_wgrad_splits_wide_tiles(cout, kd, m_total, want):
    """The weight gradient's slicing on the 128 x 256 tiling, one block an
    SM: ``wgrad_splits`` at its tile count, and ``wgrad_slicing``'s slices
    of whole WGRAD_ROW_ALIGN rows that cover the rows once."""
    tiles = -(-cout // 128) * -(-kd // 256)
    assert ck.wgrad_splits(tiles, m_total, SMS) == want
    splits, chunk = ck.wgrad_slicing(cout, kd, m_total, TILINGS[0], SMS)
    assert splits == want and chunk % ck.WGRAD_ROW_ALIGN == 0
    assert (splits - 1) * chunk < m_total <= splits * chunk <= splits * ck.WGRAD_SLICE_ROWS


# Every stride-1 convolution the benchmark's cells run, (B T, Cin, Cout,
# K): letters (B = 64 at T' = 1000, 7 mid blocks and the wide block), then
# the gated ConvNet's 17 layers (B = 16, T = 2000); and for each, the
# tiling of its forward, dgrad and wgrad and the wgrad's slices.
CELL_CONVS = [
    ("letters_mid", 64_000, 250, 250, 7, "128x256", "128x256", "128x256", 9),
    ("letters_wide", 64_000, 250, 2000, 7, "128x256", "128x256", "128x256", 8),
    ("glu_1", 32_000, 40, 400, 13, "128x256", "128x128", "128x256", 8),
    ("glu_2", 32_000, 200, 440, 14, "128x256", "128x256", "128x256", 6),
    ("glu_3", 32_000, 220, 484, 15, "128x256", "128x256", "128x256", 5),
    ("glu_4", 32_000, 242, 532, 16, "128x128", "128x256", "128x128", 5),
    ("glu_5", 32_000, 266, 584, 17, "128x128", "128x128", "128x256", 7),
    ("glu_6", 32_000, 292, 642, 18, "128x256", "128x128", "128x256", 4),
    ("glu_7", 32_000, 321, 706, 19, "128x256", "128x128", "128x256", 7),
    ("glu_8", 32_000, 353, 776, 20, "128x128", "128x128", "128x256", 4),
    ("glu_9", 32_000, 388, 852, 21, "128x128", "128x256", "128x256", 4),
    ("glu_10", 32_000, 426, 936, 22, "128x256", "128x256", "128x256", 4),
    ("glu_11", 32_000, 468, 1028, 23, "128x128", "128x256", "128x256", 4),
    ("glu_12", 32_000, 514, 1130, 24, "128x128", "128x128", "128x128", 5),
    ("glu_13", 32_000, 565, 1242, 25, "128x256", "128x128", "128x256", 4),
    ("glu_14", 32_000, 621, 1366, 26, "128x128", "128x128", "128x256", 4),
    ("glu_15", 32_000, 683, 1502, 27, "128x256", "128x256", "128x256", 4),
    ("glu_16", 32_000, 751, 1652, 28, "128x128", "128x256", "128x256", 4),
    ("glu_17", 32_000, 826, 1816, 29, "128x128", "128x128", "128x256", 4),
]


@pytest.mark.parametrize("name,m,cin,cout,k,fwd,dgrad,wgrad,splits", CELL_CONVS)
def test_tiling_rule_at_the_cells_shapes(name, m, cin, cout, k, fwd, dgrad, wgrad, splits):
    """``pick_tiling`` as a pure function of the product's rows, columns
    and depth over the tiling table: the forward (B T x Cout over K Cin),
    dgrad (B T x Cin over K Cout) and wgrad (Cout x K Cin over B T, sliced);
    and the wgrad's slices there, each the first design's count."""
    names = [t.name for t in TILINGS]
    assert names[ck.pick_tiling(m, cout, k * cin, TILINGS, SMS)] == fwd
    assert names[ck.pick_tiling(m, cin, k * cout, TILINGS, SMS)] == dgrad
    which = ck.pick_tiling(cout, k * cin, m, TILINGS, SMS, sliced=True)
    assert names[which] == wgrad
    assert ck.wgrad_slicing(cout, k * cin, m, TILINGS[which], SMS)[0] == splits


@pytest.mark.parametrize("rows,cols,depth,sliced,want,tie", [
    (32_000, 936, 9_372, False, 0, True),      # 1000 or 2000 blocks: 8 waves either way
    (32_000, 1816, 23_954, False, 1, False),   # 16 waves of 128 x 256 against 15
    (32_000, 826, 52_664, False, 1, False),    # 1000 blocks in 8 waves against 1750 in 7
    (64_000, 250, 1750, False, 0, True),
    (532, 3872, 32_000, True, 1, False),       # 8 slices in 5 waves against 5 in 3
    (1816, 23_954, 32_000, True, 0, True),     # 4 slices, 43 waves either way
])
def test_tiling_rule_counts_padded_waves(rows, cols, depth, sliced, want, tie):
    """The fewest waves of padded tiles (times a slice's depth where
    sliced) wins, and a tie goes to the first tiling listed."""
    assert ck.pick_tiling(rows, cols, depth, TILINGS, SMS, sliced) == want
    again = ck.pick_tiling(rows, cols, depth, TILINGS[::-1], SMS, sliced)
    assert again == (0 if tie else 1 - want)


@pytest.fixture
def kernel_path(monkeypatch):
    """The kernels' path on the CPU: each pass picks its tiling from
    TILINGS on a 132-SM card and counts its launch, with the launches
    replaced by the plain products.  Returns the (pass, shape, tiling
    index) of every launch."""
    launched = []

    def product(x, matrix, bias, relu, left, which):
        launched.append(("product", tuple(x.shape), matrix.shape[1], which))
        b, t, c = x.shape
        out = ck.unfold(x, matrix.shape[0] // c, left) @ matrix
        out = out if bias is None else out + bias
        return (torch.relu(out) if relu else out).view(b, t, -1)

    def wgrad(g, x, kernel, which):
        launched.append(("wgrad", tuple(x.shape), g.shape[2], which))
        return ck.conv_wgrad_plain(g, x, kernel)

    monkeypatch.setattr(ck, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(ck, "tiling", lambda: TILINGS)
    monkeypatch.setattr(ck, "_sms", lambda device: SMS)
    monkeypatch.setattr(ck, "_unfold_product", product)
    monkeypatch.setattr(ck, "_wgrad_product", wgrad)
    return launched


@pytest.mark.parametrize("block,relu,shapes", [
    (ck.conv_relu, True, [(2, 13, 5, 6, 7), (3, 9, 6, 300, 7)]),
    (ck.conv_bias, False, [(2, 12, 6, 8, 14), (1, 20, 4, 130, 13), (2, 5, 129, 3, 2)]),
])
def test_launches_by_tiling_add_up(kernel_path, block, relu, shapes):
    """Each pass counts one launch a call in the launch ledger under its id
    and one under ``<id>.<tiling>`` for the tiling ``pick_tiling`` chose;
    the tilings' counts add up to the total, and the outputs are the plain
    versions'."""
    LAUNCHES.clear()
    for b, t, cin, cout, k in shapes:
        gen = torch.Generator().manual_seed(b * 100 + t)
        x = torch.randn(b, t, cin, generator=gen, requires_grad=True)
        weight = torch.randn(cout, cin, k, generator=gen, requires_grad=True)
        bias = torch.randn(cout, generator=gen, requires_grad=True)
        out = block(x, weight, bias)
        torch.testing.assert_close(out, ck.conv_fwd_plain(x, weight, bias, relu))
        out.sum().backward()
    calls = len(shapes)
    for p in PASSES:
        assert LAUNCHES[p] == calls
        counts = {k[len(p) + 1:]: n for k, n in LAUNCHES.items() if k.startswith(p + ".")}
        assert sum(counts.values()) == LAUNCHES[p]
        assert set(counts) <= {t.name for t in TILINGS}
    picked = [TILINGS[which].name for _, _, _, which in kernel_path]
    assert len(picked) == 3 * calls
    for t in TILINGS:
        assert sum(LAUNCHES[f"{p}.{t.name}"] for p in PASSES) == picked.count(t.name)


@pytest.mark.parametrize("calls,want", [
    ([("K2", "warp"), ("K2", "block"), ("K2", "warp")], {"K2": 3, "K2.warp": 2, "K2.block": 1}),
    ([("conv_fwd", "128x256"), ("conv_dgrad", "128x128"), ("K9",), ("conv_fwd", "128x256")],
     {"conv_fwd": 2, "conv_fwd.128x256": 2, "conv_dgrad": 1, "conv_dgrad.128x128": 1,
      "K9": 1}),
    ([("K1", "warp"), ("K1s", "block")], {"K1": 1, "K1.warp": 1, "K1s": 1, "K1s.block": 1}),
    ([("K9",), ("K9",)], {"K9": 2}),
    ([("K3", "warp", "fp64"), ("K3", "block", "fp64")],
     {"K3": 2, "K3.warp": 1, "K3.block": 1, "K3.fp64": 2}),
    ([], {}),
])
def test_count_launch_keeps_totals_and_kinds(calls, want):
    """``count_launch`` adds one to the kernel's total and one to each kind
    it names, keeps two kernels apart (also where one id begins the other),
    and counts nothing until it is called."""
    LAUNCHES.clear()
    for call in calls:
        kcommon.count_launch(*call)
    assert LAUNCHES == want


def test_chip_smoke_reads_launches_by_tiling(kernel_path):
    """The launch ledger holds each pass's launches beside its launches by
    tiling, and ``chip_smoke.check_conv_tilings`` reads them there and fails
    until every pass has a compared launch on every tiling."""
    LAUNCHES.clear()
    import chip_smoke

    gen = torch.Generator().manual_seed(5)
    leaves = [torch.randn(shape, generator=gen, requires_grad=True)
              for shape in ((2, 9, 6), (8, 6, 7), (8,))]
    ck.conv_bias(*leaves).sum().backward()
    first = TILINGS[0].name
    assert LAUNCHES == {key: 1 for p in PASSES for key in (p, f"{p}.{first}")}
    with pytest.raises(RuntimeError, match="never held against float64"):
        chip_smoke.check_conv_tilings(LAUNCHES)
    second = {f"{p}.{TILINGS[1].name}": 1 for p in PASSES}
    chip_smoke.check_conv_tilings(LAUNCHES, second)
    LAUNCHES.clear()
    with pytest.raises(RuntimeError, match="never held against float64"):
        chip_smoke.check_conv_tilings(LAUNCHES, second)


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


