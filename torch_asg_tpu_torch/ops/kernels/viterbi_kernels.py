"""1-best Viterbi decoding: the max-plus forward (K10) and the backtrace (K11).

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/viterbi.cu``); on CPU tensors it runs the plain version beside it,
a step-by-step loop of the same arithmetic.  Ties resolve to the lowest
source label, so paths are bit-identical across the kernel, its plain
version and the ``'xla'`` tier of ``ops/viterbi.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .common import (KERNEL_DTYPES, check_tensor, ptr, raise_on_error,
                     stream_ptr, use_kernel)
from ..semiring import NEG_INF
from ...utils.lengths import mask_emissions

# The forward kernel runs one thread per destination label in one block.
VITERBI_KERNEL_MAX_LABELS = 1024


def argmax_first(x: torch.Tensor, dim: int):
    """(max, lowest index reaching it) along ``dim``, as int64."""
    best = torch.amax(x, dim=dim, keepdim=True)
    idx = torch.arange(x.shape[dim], device=x.device)
    shape = [1] * x.dim()
    shape[dim] = -1
    idx = idx.view(shape).expand_as(x)
    arg = torch.where(x == best, idx, x.shape[dim]).amin(dim=dim)
    return best.squeeze(dim), arg


def viterbi_forward_plain(transition, inputs, input_lengths):
    """Plain version of K10: (d_end (B, N), backptr (T, B, N) int32)."""
    t_total, num_batches, num_labels = inputs.shape
    li = input_lengths.to(inputs.device)
    inputs_m = mask_emissions(inputs, li)
    bp = torch.empty((t_total, num_batches, num_labels), dtype=torch.int32,
                     device=inputs.device)
    bp[0] = torch.arange(num_labels, dtype=torch.int32, device=inputs.device)
    d = inputs_m[0]
    d_end = torch.where((li - 1 == 0)[:, None], d, NEG_INF)
    for t in range(1, t_total):
        best, arg = argmax_first(transition[None, :, :] + d[:, None, :], dim=2)
        d = inputs_m[t] + best
        bp[t] = arg
        d_end = torch.where((li - 1 == t)[:, None], d, d_end)
    return d_end, bp


def viterbi_backtrace_plain(final_labels, backptr, input_lengths):
    """Plain version of K11: the (T, B) int32 path, -1 past L_in.

    backptr[t] maps the label at frame t to the label at frame t-1."""
    t_total, num_batches, num_labels = backptr.shape
    li = input_lengths.to(backptr.device)
    final = final_labels.to(device=backptr.device, dtype=torch.int32)
    final = final.clamp(0, num_labels - 1)
    pad = torch.full_like(final, -1)
    paths = torch.empty((t_total, num_batches), dtype=torch.int32,
                        device=backptr.device)
    lab = torch.where(li - 1 == t_total - 1, final, pad)
    paths[t_total - 1] = lab
    for t in range(t_total - 2, -1, -1):
        src = lab.clamp(min=0).long()[:, None]
        prev = torch.gather(backptr[t + 1], 1, src)[:, 0]
        lab = torch.where(li - 1 == t, final, torch.where(t < li - 1, prev, pad))
        paths[t] = lab
    return paths


def _lib_fn(name, n_ptrs):
    from ._build import load

    fn = getattr(load("viterbi"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def viterbi_forward_pallas(transition, inputs, input_lengths):
    """(d_end (B, N), backptr (T, B, N) int32): K10 on CUDA tensors, its plain
    version on CPU ones.  backptr[t] maps the label AT frame t to the label
    at frame t-1 (frame 0 carries the identity row).

    ``viterbi_forward_pallas.launches`` counts the kernel's launches.
    """
    if not use_kernel(inputs, transition, input_lengths):
        return viterbi_forward_plain(transition, inputs, input_lengths)
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"viterbi forward kernel takes float32 or float64, got {dt}")
    if num_labels > VITERBI_KERNEL_MAX_LABELS:
        raise ValueError(
            f"viterbi forward kernel takes num_labels <= "
            f"{VITERBI_KERNEL_MAX_LABELS}; got {num_labels}")
    trans_t = transition.to(dt).t().contiguous()
    li = input_lengths.to(torch.int32).contiguous()
    check_tensor("inputs", inputs, dt, (t_total, num_batches, num_labels), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)
    bp = torch.empty((t_total, num_batches, num_labels), dtype=torch.int32, device=dev)
    d_end = torch.empty((num_batches, num_labels), dtype=dt, device=dev)
    if bp.numel() == 0:
        return d_end.fill_(NEG_INF), bp
    fn = _lib_fn("viterbi_forward_f32" if dt == torch.float32
                 else "viterbi_forward_f64", 5)
    with torch.cuda.device(dev):
        err = fn(ptr(trans_t), ptr(inputs), ptr(li), ptr(bp), ptr(d_end),
                 t_total, num_batches, num_labels, stream_ptr(dev))
    raise_on_error("viterbi_forward", err)
    viterbi_forward_pallas.launches += 1
    return d_end, bp


def viterbi_backtrace_pallas(final_labels, backptr, input_lengths):
    """(T, B) int32 path from (T, B, N) backpointers, -1 past L_in: K11 on
    CUDA tensors, its plain version on CPU ones.

    ``viterbi_backtrace_pallas.launches`` counts the kernel's launches.
    """
    if not use_kernel(backptr, final_labels, input_lengths):
        return viterbi_backtrace_plain(final_labels, backptr, input_lengths)
    t_total, num_batches, num_labels = backptr.shape
    dev = backptr.device
    fin = final_labels.to(torch.int32).contiguous()
    li = input_lengths.to(torch.int32).contiguous()
    check_tensor("backptr", backptr, torch.int32,
                 (t_total, num_batches, num_labels), dev)
    check_tensor("final_labels", fin, torch.int32, (num_batches,), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)
    paths = torch.empty((t_total, num_batches), dtype=torch.int32, device=dev)
    if paths.numel() == 0 or num_labels == 0:
        return paths.fill_(-1)
    fn = _lib_fn("viterbi_backtrace", 4)
    with torch.cuda.device(dev):
        err = fn(ptr(backptr), ptr(fin), ptr(li), ptr(paths),
                 t_total, num_batches, num_labels, stream_ptr(dev))
    raise_on_error("viterbi_backtrace", err)
    viterbi_backtrace_pallas.launches += 1
    return paths


viterbi_forward_pallas.launches = 0
viterbi_backtrace_pallas.launches = 0
