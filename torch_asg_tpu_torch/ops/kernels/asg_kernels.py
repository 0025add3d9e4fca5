"""Fused forward-only ASG scores: both beta chains in one kernel (K1).

``asg_scores_fused`` gathers the aligned lattice (``ops/fac.py``), builds the
exp-domain transition ``E = exp(T - c)``, runs both beta chains with t
descending, and repays the FCC chain's per-step ``exp(-c)`` scaling as
``(L_in - 1) * c``.  On CUDA tensors the chains run in the hand-written
kernel ``csrc/asg_fwd.cu``; on CPU tensors in ``_fwd_scores_plain``, a
step-by-step loop of the same arithmetic.

Numeric domains: the FCC chain runs in the exp domain with a per-step
rescale to max 1 and the log-maxes summed into an offset (full connectivity
bounds a row's spread by one step's emission + transition spread, which the
60-nat guard in ``asg.py`` keeps inside the fp32 exp range).  The FAC chain
stays in the log domain, because an aligned row's spread grows with
``|s - t*S/T|``.

Gradients (the store variant of the kernel and the backward kernel) land
with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from .common import (KERNEL_DTYPES, check_tensor, ptr, raise_on_error,
                     stream_ptr, use_kernel)
from ..fac import _shift_left_s, make_aligned
from ..semiring import NEG_INF, logaddexp

# Widest label / target width the kernel's one-thread-per-lane block takes.
KERNEL_MAX_WIDTH = 1024


def _prepare(transition, inputs, targets, input_lengths, target_lengths):
    """Aligned gathers, ``E = exp(T - c)`` and ``c`` (the max finite
    transition, 0 when there is none): every exp argument stays <= 0."""
    lat = make_aligned(transition, inputs, targets, input_lengths, target_lengths)
    transition = transition.to(inputs.dtype)
    c = torch.amax(transition)
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    e = torch.exp(transition - c)  # e[j, i] = exp(T[j, i] - c); beta contracts j
    return lat, e, c


def _fix_scores(sful, sfac, input_lengths, c):
    # Repay the FCC chain's per-step exp(-c) scaling: the beta recursion runs
    # L_in - 1 steps from its seed, one transition each.
    steps = input_lengths.to(sful.dtype) - 1.0
    return sful + steps * c, sfac


def _exp_rows(x):
    """(exp(x - rowmax), rowmax) with all--inf rows mapping to (0, 0)."""
    m = torch.amax(x, dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.exp(x - m[:, None]), m


def _fwd_scores_plain(e, self_trans, next_trans, inputs, aligned,
                      input_lengths, target_lengths):
    """Plain version of the kernel: (sful, sfac), each (B,), before the
    ``(L_in - 1) * c`` repayment.

    Walks t from T-1 down to 0 for the whole batch at once.  Each element
    re-seeds at its own ``t = L_in - 1`` (FCC beta = 1 on every label,
    FAC beta = 0 at ``s = L_out - 1``), which discards whatever the chains
    held at later frames.  An element with L_in outside [1, T] is never
    seeded and has no path: both scores are -inf, as in the kernel.
    """
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    li = input_lengths.to(device=dev, dtype=torch.long)
    lo = target_lengths.to(device=dev, dtype=torch.long)
    seed_fcc = torch.ones((num_batches, num_labels), dtype=dt, device=dev)
    s_idx = torch.arange(s_total, device=dev)
    seed_fac = torch.full((num_batches, s_total), NEG_INF, dtype=dt, device=dev)
    seed_fac = seed_fac.masked_fill(s_idx[None, :] == (lo - 1)[:, None], 0.0)

    pb = torch.zeros((num_batches, num_labels), dtype=dt, device=dev)
    qb = torch.full((num_batches, s_total), NEG_INF, dtype=dt, device=dev)
    off = torch.zeros((num_batches,), dtype=dt, device=dev)
    # exp-domain emission row of frame t+1 and its log-max (the "next" frame)
    ex_n = torch.zeros_like(pb)
    m_n = torch.zeros_like(off)
    ai_n = torch.full_like(qb, NEG_INF)
    for t in range(t_total - 1, -1, -1):
        seed = li - 1 == t
        acc = (pb * ex_n) @ e
        m = torch.amax(acc, dim=1)
        m_s = torch.where(m > 0, m, torch.ones_like(m))
        pb = torch.where(seed[:, None], seed_fcc, acc * (1.0 / m_s)[:, None])
        off = torch.where(seed, torch.zeros_like(off), off + m_n + torch.log(m_s))
        x = qb + ai_n
        raw = logaddexp(self_trans + x, next_trans + _shift_left_s(x))
        qb = torch.where(seed[:, None], seed_fac, raw)
        row = inputs[t].masked_fill((t >= li)[:, None], NEG_INF)
        ex_n, m_n = _exp_rows(row)
        ai_n = aligned[t]
    sful = torch.log(torch.sum(pb * ex_n, dim=1)) + m_n + off
    sfac = qb[:, 0] + ai_n[:, 0]
    bad = (li < 1) | (li > t_total)
    return sful.masked_fill(bad, NEG_INF), sfac.masked_fill(bad, NEG_INF)


def _fwd_scores_kernel(e, self_trans, next_trans, inputs, aligned,
                       input_lengths, target_lengths):
    """Launch ``asg_fwd_scores_{f32,f64}`` (csrc/asg_fwd.cu)."""
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"asg_fwd kernel takes float32 or float64, got {dt}")
    if max(num_labels, s_total) > KERNEL_MAX_WIDTH:
        raise ValueError(
            f"asg_fwd kernel takes max(num_labels, s_total) <= {KERNEL_MAX_WIDTH}; "
            f"got num_labels={num_labels}, s_total={s_total}")
    li = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    lo = target_lengths.to(device=dev, dtype=torch.int32).contiguous()
    for name, t, shape in (
        ("e", e, (num_labels, num_labels)),
        ("self_trans", self_trans, (num_batches, s_total)),
        ("next_trans", next_trans, (num_batches, s_total)),
        ("inputs", inputs, (t_total, num_batches, num_labels)),
        ("aligned", aligned, (t_total, num_batches, s_total)),
    ):
        check_tensor(name, t, dt, shape, dev)
    for name, t in (("input_lengths", li), ("target_lengths", lo)):
        check_tensor(name, t, torch.int32, (num_batches,), dev)
    sful = torch.empty((num_batches,), dtype=dt, device=dev)
    sfac = torch.empty((num_batches,), dtype=dt, device=dev)
    if num_batches == 0:
        return sful, sfac
    fn = _c_fn(dt)
    with torch.cuda.device(dev):
        err = fn(ptr(inputs), ptr(aligned), ptr(e), ptr(self_trans),
                 ptr(next_trans), ptr(li), ptr(lo), ptr(sful), ptr(sfac),
                 t_total, num_batches, num_labels, s_total, stream_ptr(dev))
    raise_on_error(fn.__name__, err)
    asg_scores_fused.launches += 1
    return sful, sfac


def _c_fn(dtype):
    from ._build import load

    fn = getattr(load("asg_fwd"), "asg_fwd_scores_f32" if dtype == torch.float32
                 else "asg_fwd_scores_f64")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def asg_scores_fused(transition, inputs, targets, input_lengths, target_lengths):
    """(full_scores, aligned_scores), each (B,), from one pass of both beta
    chains: the K1 kernel on CUDA tensors, its plain version on CPU ones.

    ``asg_scores_fused.launches`` counts the kernel's launches.
    """
    lat, e, c = _prepare(transition, inputs, targets, input_lengths, target_lengths)
    args = (e, lat.self_trans.contiguous(), lat.next_trans.contiguous(),
            inputs.contiguous(), lat.inputs.contiguous(), input_lengths,
            target_lengths)
    run = _fwd_scores_kernel if use_kernel(inputs, transition) else _fwd_scores_plain
    sful, sfac = run(*args)
    return _fix_scores(sful, sfac, input_lengths.to(inputs.device), c)


asg_scores_fused.launches = 0
