"""The encoder's stride-1 convolutions on channels-last float32 activations.

A block of stride 1 and width K with SAME padding (``same_pads``: (K - 1) // 2
frames on the left, K // 2 on the right; equal when K is odd) computes
``conv1d(x) + bias``, with a ReLU for a Wav2Letter block.  Here that is an
implicit GEMM over (B, T, C) activations, whose row (b, t) unfolds to the
K * C contiguous floats of frames t - left .. t + right (``unfold``):

* forward: ``out = relu?(unfold(x) @ W + bias)``, W[k * Cin + c, n] =
  weight[n, c, k] (``forward_matrix``); the bias and ReLU are the kernel's
  epilogue and the padding its predicate, so no padded copy is made;
* dgrad: ``dx = unfold'(g) @ Wd``, Wd[k * Cout + n, c] = weight[n, c, K-1-k]
  (``dgrad_matrix``): the transposed convolution is the same product on the
  flipped weight with the pads swapped (``unfold'`` starts ``right``
  frames back);
* wgrad: ``dW = g^T @ unfold(x)``, laid back out as (Cout, Cin, K).

``g`` is the incoming gradient, with the ReLU's mask applied (``out > 0``)
where the block has one.  ``conv_relu`` is a Wav2Letter block's forward
under autograd: its backward keeps only the block's input and output, both
alive anyway as the neighbouring blocks' output and input.  ``conv_bias``
is the bias-only sibling (a gated block's convolution, whose GLU follows
in plain ops): its backward keeps the input alone.  The parameters keep
their ``nn.Conv1d`` shapes; the weight is laid out inside each call (1.75 MB
at 250 -> 250, K = 7).

On CUDA tensors ``conv_fwd``, ``conv_dgrad`` and ``conv_wgrad`` launch the
kernels of ``csrc/conv.cu`` (float32 only) on the tiling ``pick_tiling``
takes for the product's shape; on CPU tensors they run the plain versions
beside them, the same products with whole-matrix ``@``.
The model reaches them through ``models/wav2letter.py::conv_route``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .common import (c_function, check_tensor, count_launch, ptr, raise_on_error, stream_ptr,
                     use_kernel, wants_grad)
from ...utils.profiling import span

# The most rows of m one weight-gradient accumulator sums alone before its
# slice's partial product is added to the others (in slice order).
WGRAD_SLICE_ROWS = 8192
# Least share of the last wave of resident blocks the weight gradient's
# slicing fills, where a count of slices reaches it.
WGRAD_FILL = 0.95
# A slice's rows are a whole number of these (whole stages of every
# tiling's depth).
WGRAD_ROW_ALIGN = 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Tiling(NamedTuple):
    """One block tiling of ``csrc/conv.cu``: a block computes a ``rows`` x
    ``cols`` tile of the product over reduction stages of ``depth``, and
    ``blocks_per_sm`` blocks are resident on a streaming multiprocessor."""

    rows: int
    cols: int
    depth: int
    blocks_per_sm: int

    @property
    def name(self) -> str:
        return f"{self.rows}x{self.cols}"


@functools.cache
def tiling() -> tuple:
    """Every tiling as ``csrc/conv.cu`` reports them (``Tiling``s), in the
    order its entry points number them."""
    from ._build import load

    fn = load("conv").conv_tiling
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    out = (ctypes.c_int * 17)()  # the count, then 4 numbers a tiling: room for 4
    fn(out)
    return tuple(Tiling(*out[1 + 4 * i:5 + 4 * i]) for i in range(out[0]))


def pick_tiling(rows: int, cols: int, depth: int, tilings: tuple, sms: int,
                sliced: bool = False) -> int:
    """The index in ``tilings`` of the tiling for a ``rows`` x ``cols``
    product over ``depth`` on ``sms`` streaming multiprocessors: the one
    whose blocks, padded to whole tiles, take the fewest waves of the
    card's resident slots times the work of a wave (a wave of either tiling
    holds the same tile area an SM), the first listed on a tie.  With
    ``sliced`` (the weight gradient) the depth is cut into
    ``wgrad_slicing``'s slices, each a block of its own."""
    def cost(i):
        t = tilings[i]
        blocks = -(-rows // t.rows) * -(-cols // t.cols)
        splits, chunk = wgrad_slicing(rows, cols, depth, t, sms) if sliced else (1, depth)
        slots = t.blocks_per_sm * sms
        return -(-blocks * splits // slots) * t.rows * t.cols * t.blocks_per_sm * chunk

    return min(range(len(tilings)), key=lambda i: (cost(i), i))


def same_pads(kernel: int) -> tuple:
    """(left, right) SAME padding of a stride-1 convolution of width
    ``kernel``: (K - 1) // 2 and K // 2."""
    return (kernel - 1) // 2, kernel // 2


def unfold(x: torch.Tensor, kernel: int, left: int) -> torch.Tensor:
    """(B * T, K * C): row (b, t) is frames t - left .. t - left + K - 1 of
    ``x`` (B, T, C), zeros outside [0, T)."""
    b, t, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, left, kernel - 1 - left))
    return xp.unfold(1, kernel, 1).transpose(2, 3).reshape(b * t, kernel * c)


def forward_matrix(weight: torch.Tensor) -> torch.Tensor:
    """(K * Cin, Cout): row k * Cin + c is weight[:, c, k]."""
    cout, cin, k = weight.shape
    return weight.permute(2, 1, 0).reshape(k * cin, cout)


def dgrad_matrix(weight: torch.Tensor) -> torch.Tensor:
    """(K * Cout, Cin): row k * Cout + n is weight[n, :, K - 1 - k]."""
    cout, cin, k = weight.shape
    return weight.flip(2).permute(2, 0, 1).reshape(k * cout, cin)


def _panel(matrix: torch.Tensor, t: Tiling) -> torch.Tensor:
    """``matrix`` zero-padded to whole stages of rows and whole tiles of
    columns of tiling ``t``, as its kernel reads it (16-byte copies, no
    predicate)."""
    rows, cols = matrix.shape
    out = matrix.new_zeros((_round_up(rows, t.depth), _round_up(cols, t.cols)))
    out[:rows, :cols] = matrix
    return out


def conv_fwd_plain(x, weight, bias, relu=True):
    """Plain version of the forward: (B, T, Cout)."""
    b, t, _ = x.shape
    k = weight.shape[-1]
    out = unfold(x, k, same_pads(k)[0]) @ forward_matrix(weight)
    if bias is not None:
        out = out + bias
    return (torch.relu(out) if relu else out).view(b, t, -1)


def conv_dgrad_plain(g, weight):
    """Plain version of the input gradient: (B, T, Cin) from the masked
    gradient ``g`` (B, T, Cout)."""
    b, t, _ = g.shape
    k = weight.shape[-1]
    return (unfold(g, k, same_pads(k)[1]) @ dgrad_matrix(weight)).view(b, t, -1)


def conv_wgrad_plain(g, x, kernel):
    """Plain version of the weight gradient: (Cout, Cin, K) from the masked
    gradient ``g`` (B, T, Cout) and the input ``x`` (B, T, Cin)."""
    cout, cin = g.shape[-1], x.shape[-1]
    dw = g.reshape(-1, cout).T @ unfold(x, kernel, same_pads(kernel)[0])
    return dw.view(cout, kernel, cin).permute(0, 2, 1).contiguous()


def _check(name, t, channels=None):
    """Raise unless ``t`` is a contiguous float32 (B, T, C) CUDA tensor the
    kernels can index with 32-bit offsets."""
    if t.dim() != 3:
        raise ValueError(f"{name}: expected (B, T, C), got shape {tuple(t.shape)}")
    check_tensor(name, t, torch.float32,
                 (*t.shape[:2], t.shape[2] if channels is None else channels), t.device)
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements; the kernels index below 2**31")


def _check_weight(weight, cin):
    if weight.dim() != 3 or weight.shape[1] != cin:
        raise ValueError(f"weight: expected (Cout, {cin}, K), got {tuple(weight.shape)}")
    if weight.dtype != torch.float32:
        raise TypeError(f"weight: expected torch.float32, got {weight.dtype}")


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _unfold_product(x, matrix, bias, relu, left, which):
    """Launch ``conv_fwd_f32`` on tiling ``which``: (B, T, N) =
    relu?(unfold(x, K, left) @ matrix + bias?)."""
    b, t, c = x.shape
    kd, n = matrix.shape
    panel = _panel(matrix, tiling()[which])
    out = x.new_empty((b, t, n))
    if out.numel() >= 2 ** 31:
        raise ValueError(f"out: {out.numel()} elements; the kernels index below 2**31")
    fn = c_function("conv", "conv_fwd", torch.float32, 4, 10)
    with torch.cuda.device(x.device):
        err = fn(ptr(x), ptr(panel), ctypes.c_void_p(None) if bias is None else ptr(bias),
                 ptr(out), b * t, n, panel.shape[1], t, c, kd, panel.shape[0], left,
                 int(relu), which, stream_ptr(x.device))
    raise_on_error(fn.__name__, err)
    return out


def conv_fwd(x, weight, bias, relu=True):
    """``relu?(conv1d(x) + bias)`` of a stride-1 SAME block on channels-last
    ``x`` (B, T, Cin) -> (B, T, Cout); ``bias`` (Cout,) or None; the ReLU
    where ``relu``.  Counts each launch in ``common.LAUNCHES`` as
    ``conv_fwd`` and ``conv_fwd.<tiling>``."""
    if not use_kernel(x, weight):
        return conv_fwd_plain(x, weight, bias, relu)
    _check("x", x)
    _check_weight(weight, x.shape[2])
    if bias is not None:
        check_tensor("bias", bias, torch.float32, (weight.shape[0],), x.device)
    b, t, _ = x.shape
    k = weight.shape[-1]
    which = pick_tiling(b * t, weight.shape[0], k * x.shape[2], tiling(), _sms(x.device))
    out = _unfold_product(x, forward_matrix(weight), bias, relu, same_pads(k)[0], which)
    count_launch("conv_fwd", tiling()[which].name)
    return out


def conv_dgrad(g, weight):
    """The input gradient (B, T, Cin) of a stride-1 SAME block from the
    masked gradient ``g`` (B, T, Cout).  Counts each launch in
    ``common.LAUNCHES`` as ``conv_dgrad`` and ``conv_dgrad.<tiling>``."""
    if not use_kernel(g, weight):
        return conv_dgrad_plain(g, weight)
    _check("g", g, weight.shape[0])
    _check_weight(weight, weight.shape[1])
    b, t, _ = g.shape
    cin, k = weight.shape[1:]
    which = pick_tiling(b * t, cin, k * weight.shape[0], tiling(), _sms(g.device))
    out = _unfold_product(g, dgrad_matrix(weight), None, False, same_pads(k)[1], which)
    count_launch("conv_dgrad", tiling()[which].name)
    return out


def wgrad_splits(tiles: int, m_total: int, slots: int) -> int:
    """Slices of the m = B * T rows for the weight gradient of ``tiles``
    output tiles on ``slots`` resident blocks: the fewest, from the least
    that keeps each slice within WGRAD_SLICE_ROWS rows up to twice that,
    whose blocks fill the last wave by WGRAD_FILL; else the count that
    fills it best."""
    least = max(1, -(-m_total // WGRAD_SLICE_ROWS))

    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // slots) * slots)

    counts = range(least, 2 * least + 1)
    return next((s for s in counts if fill(s) >= WGRAD_FILL), max(counts, key=fill))


def conv_wgrad(g, x, kernel):
    """The weight gradient (Cout, Cin, K) of a stride-1 SAME block from the
    masked gradient ``g`` (B, T, Cout) and its input ``x`` (B, T, Cin):
    partial products over slices of B * T, summed in slice order.  Counts
    each launch in ``common.LAUNCHES`` as ``conv_wgrad`` and
    ``conv_wgrad.<tiling>``."""
    if not use_kernel(g, x):
        return conv_wgrad_plain(g, x, kernel)
    _check("x", x)
    _check("g", g)
    if g.shape[:2] != x.shape[:2]:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} must share (B, T)")
    b, t, cin = x.shape
    which = pick_tiling(g.shape[2], kernel * cin, b * t, tiling(), _sms(x.device), sliced=True)
    dw = _wgrad_product(g, x, kernel, which)
    count_launch("conv_wgrad", tiling()[which].name)
    return dw


def wgrad_slicing(cout: int, kd: int, m_total: int, t: Tiling, sms: int) -> tuple:
    """(splits, chunk): the weight gradient's slices of the ``m_total`` rows
    for a (``cout``, ``kd``) product on tiling ``t``: ``wgrad_splits``'
    count, then each slice a whole number of WGRAD_ROW_ALIGN rows."""
    tiles = -(-cout // t.rows) * -(-kd // t.cols)
    splits = wgrad_splits(tiles, m_total, t.blocks_per_sm * sms)
    chunk = _round_up(-(-m_total // splits), WGRAD_ROW_ALIGN)
    return -(-m_total // chunk), chunk


def _wgrad_product(g, x, kernel, which):
    """Launch ``conv_wgrad_f32`` on tiling ``which``: (Cout, Cin, K)."""
    b, t, cin = x.shape
    cout, m_total = g.shape[2], b * t
    kd = kernel * cin
    splits, chunk = wgrad_slicing(cout, kd, m_total, tiling()[which], _sms(x.device))
    part = x.new_empty((splits, cout, kd))
    dw = x.new_empty((cout, cin, kernel))
    fn = c_function("conv", "conv_wgrad", torch.float32, 4, 9)
    with torch.cuda.device(x.device):
        err = fn(ptr(g), ptr(x), ptr(part), ptr(dw), m_total, cout, t, cin, kernel,
                 same_pads(kernel)[0], splits, chunk, which, stream_ptr(x.device))
    raise_on_error(fn.__name__, err)
    return dw



class _ConvReLU(torch.autograd.Function):
    """``conv_fwd`` under autograd; saves the block's input and output."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        out = conv_fwd(x, weight, bias)
        ctx.save_for_backward(x, weight, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, out = ctx.saved_tensors
        g = torch.ops.aten.threshold_backward(grad, out, 0.0).contiguous()  # ReLU's mask
        dx = conv_dgrad(g, weight) if ctx.needs_input_grad[0] else None
        dw = conv_wgrad(g, x, weight.shape[-1]) if ctx.needs_input_grad[1] else None
        db = g.sum((0, 1)) if ctx.needs_input_grad[2] else None
        return dx, dw, db


class _ConvBias(torch.autograd.Function):
    """``conv_fwd`` without the ReLU under autograd; saves the block's input."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return conv_fwd(x, weight, bias, relu=False)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        g = grad.contiguous()
        dx = conv_dgrad(g, weight) if ctx.needs_input_grad[0] else None
        dw = conv_wgrad(g, x, weight.shape[-1]) if ctx.needs_input_grad[1] else None
        db = g.sum((0, 1)) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def _conv(function, relu, x, weight, bias):
    with span("asg.conv"):
        if wants_grad(x, weight, *(() if bias is None else (bias,))):
            return function.apply(x, weight, bias)
        return conv_fwd(x, weight, bias, relu)


def conv_relu(x, weight, bias):
    """``relu(conv1d(x) + bias)`` of a stride-1 SAME block on contiguous
    channels-last ``x`` (B, T, Cin) -> (B, T, Cout), with its backward where
    autograd asks for one.  Under a profiler each call is the span
    ``asg.conv``."""
    return _conv(_ConvReLU, True, x, weight, bias)


def conv_bias(x, weight, bias):
    """``conv1d(x) + bias`` of a stride-1 SAME block, as ``conv_relu`` without
    the ReLU: the forward's epilogue adds the bias alone and the backward
    takes the incoming gradient unmasked.  One ``asg.conv`` span a call."""
    return _conv(_ConvBias, False, x, weight, bias)
