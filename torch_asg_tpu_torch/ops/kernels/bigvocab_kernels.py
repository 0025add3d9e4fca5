"""The matmul tier's two chains in one pass over the transition matrix (K9).

Under autograd the matmul tier (``ops/fcc.py::fcc_score_matmul``) needs
both the alpha chain (t ascending) and the beta chain (t descending).  Run
as two scans, each step of each chain streams the whole (N, N) matrix
``E = exp(T - c)`` from device memory: 2 (T - 1) N^2 elements a call, 40 GB
at N = 10,000 and T = 100 in float32.  The chains are independent, so their
steps pair up: alpha step t + 1 with beta step T - 2 - t.  Both need a full
pass over E, alpha contracting its columns and beta its rows, so one read
of E per paired step can feed both.  That halves the dominant stream.

Numerics follow the scans in structure: exp-domain rows rescaled to max 1
after each step, the log-maxes summed into a per-element offset, emission
rows exponentiated against their own row max, and the beta chain re-seeded
at 1 on every label at ``t = L_in - 1``.  The outputs are the log-domain
streams of ``_alpha_scan_mm`` and ``_beta_scan_mm``: alpha[0] = I_m[0] and
beta[T - 1] = the seed row (0 where L_in == T, else -inf).

On CUDA tensors ``fcc_dual_streams`` launches the hand-written kernels of
``csrc/bigvocab.cu``; on CPU tensors it runs ``fcc_dual_streams_plain``, a
step-by-step loop of the same arithmetic with whole-matrix products.
"""

from __future__ import annotations

import ctypes

import torch

from .common import (KERNEL_DTYPES, check_tensor, count_launch, exp_rows, ptr,
                     raise_on_error, stream_ptr, use_kernel)
from ..semiring import NEG_INF


def _rescale(row):
    """Renormalise an exp-domain row to max 1; returns (row', log max)."""
    m = torch.amax(row, dim=1, keepdim=True)
    m_s = torch.where(m > 0, m, torch.ones_like(m))
    return row * (1.0 / m_s), torch.log(m_s)


def _exp_mats(transition, dtype):
    """(e, c): ``e[i, j] = exp(T[i, j] - c)`` with c the max entry (0 when it
    is not finite), so every exponent is <= 0."""
    c = torch.amax(transition)
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c)).to(dtype)
    return torch.exp(transition.to(dtype) - c), c


def _boundary(inputs_m, input_lengths):
    """beta[T - 1]: 0 where L_in == T, else -inf."""
    t_total = inputs_m.shape[0]
    zeros = torch.zeros(inputs_m.shape[1:], dtype=inputs_m.dtype, device=inputs_m.device)
    return torch.where((input_lengths == t_total)[:, None], zeros, NEG_INF)


def fcc_dual_streams_plain(transition, inputs_m, input_lengths):
    """Plain version of K9: (alpha, beta), each (T, B, N), log domain.

    Paired step st = 0 .. T - 2, for the whole batch at once:
      xa = pa,  xb = pb * exp(I[T-1-st] - rowmax)      (the rows each consumes)
      acc_a = xa @ E^T,  acc_b = xb @ E                (one matrix, both chains)
      pa = rescale(acc_a * exp(I[st+1] - rowmax)),  alpha[st+1] = log pa + offa
      pb = rescale(acc_b), re-seeded to 1 where L_in - 1 == T-2-st,
      beta[T-2-st] = log pb + offb
    with each offset collecting the row maxes, the rescale's log-maxes and c.
    """
    t_total, num_batches, num_labels = inputs_m.shape
    dev, dt = inputs_m.device, inputs_m.dtype
    li = input_lengths.to(device=dev, dtype=torch.long)[:, None]
    b_last = _boundary(inputs_m, li[:, 0])
    if t_total == 1:
        return inputs_m.clone(), b_last[None]
    e, c = _exp_mats(transition, dt)
    seed_row = torch.ones((num_batches, num_labels), dtype=dt, device=dev)
    pa, offa = exp_rows(inputs_m[0])
    offa = offa[:, None]
    pb = torch.where(li == t_total, seed_row, 0.0)
    offb = torch.zeros((num_batches, 1), dtype=dt, device=dev)
    alpha = torch.empty_like(inputs_m)
    beta = torch.empty_like(inputs_m)
    alpha[0] = inputs_m[0]
    beta[t_total - 1] = b_last
    for st in range(t_total - 1):
        eib, cib = exp_rows(inputs_m[t_total - 1 - st])
        acc_a = pa @ e.T
        acc_b = (pb * eib) @ e
        eia, cia = exp_rows(inputs_m[st + 1])
        pa, logma = _rescale(acc_a * eia)
        offa = offa + cia[:, None] + logma + c
        alpha[st + 1] = torch.log(pa) + offa
        t_b = t_total - 2 - st
        seed_b = li - 1 == t_b
        pb_raw, logmb = _rescale(acc_b)
        pb = torch.where(seed_b, seed_row, pb_raw)
        offb = torch.where(seed_b, 0.0, offb + cib[:, None] + logmb + c)
        beta[t_b] = torch.log(pb) + offb
    return alpha, beta


def _dual_kernel(transition, inputs_m, input_lengths):
    """Launch ``fcc_dual_{f32,f64}`` (csrc/bigvocab.cu): K9."""
    t_total, num_batches, num_labels = inputs_m.shape
    dev, dt = inputs_m.device, inputs_m.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"the dual-stream kernel takes float32 or float64, got {dt}")
    li = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    check_tensor("inputs_m", inputs_m, dt, (t_total, num_batches, num_labels), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)
    alpha = torch.empty_like(inputs_m)
    beta = torch.empty_like(inputs_m)
    e, c = _exp_mats(transition, dt)
    check_tensor("e", e, dt, (num_labels, num_labels), dev)
    lib = _lib()
    suffix = "f32" if dt == torch.float32 else "f64"
    scratch_fn = getattr(lib, f"fcc_dual_scratch_{suffix}")
    scratch_fn.argtypes = [ctypes.c_int] * 3
    scratch_fn.restype = ctypes.c_longlong
    fn = getattr(lib, f"fcc_dual_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        # the scratch layout follows the grid, which the device's size sets
        scratch = torch.empty((scratch_fn(t_total, num_batches, num_labels),), dtype=dt,
                              device=dev)
        err = fn(ptr(inputs_m), ptr(e), ptr(c), ptr(li), ptr(alpha), ptr(beta),
                 ptr(scratch), t_total, num_batches, num_labels, stream_ptr(dev))
    raise_on_error(fn.__name__, err)
    count_launch("K9")
    return alpha, beta


def _lib():
    from ._build import load

    return load("bigvocab")


def fcc_dual_streams(transition, inputs_m, input_lengths):
    """(alpha, beta) log-domain streams, each (T, B, N), from one pass over
    ``exp(T - c)`` per paired step: K9 on CUDA tensors, its plain version on
    CPU ones.  ``inputs_m`` holds length-masked emissions
    (``utils.lengths.mask_emissions``), as the two scans take them.

    Counts each launch in ``common.LAUNCHES`` as ``K9`` (one a call; T = 1
    pairs no step and launches nothing).
    """
    if not use_kernel(inputs_m, transition, input_lengths):
        return fcc_dual_streams_plain(transition, inputs_m, input_lengths)
    if inputs_m.shape[0] == 1:
        return inputs_m.clone(), _boundary(inputs_m, input_lengths)[None]
    if inputs_m.numel() == 0:
        return torch.empty_like(inputs_m), torch.empty_like(inputs_m)
    return _dual_kernel(transition, inputs_m, input_lengths)

