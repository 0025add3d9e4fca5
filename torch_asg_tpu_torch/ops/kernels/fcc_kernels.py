"""The fully-connected (denominator) lattice's per-lattice kernels: the
log-domain alpha and beta chains together (K3), the beta chain alone (K4)
and the backward (K5).

``fcc_score_pallas`` is the FCC half of the per-lattice tier
(``impl='pallas'``).  Every step's logsumexp over transitions is an
m-normalised exp-domain contraction against ``E = exp(T - c)``, with ``c``
the max finite transition (0 when there is none):
    lse_j(x[j] + T[j, i]) = m + log(sum_j exp(x[j] - m) E[j, i]) + c,
where ``m`` is the row max, taken as 0 on an all--inf row, and
``log(0) = -inf`` keeps dead labels dead.  The chains stay in the log
domain: alpha[t] = I[t] + lse(alpha[t-1] + T) from alpha[0] = I[0], beta
seeded 0 at ``t = L_in - 1``; frames at ``t >= L_in`` hold -inf.  An element
with L_in outside [1, T] is never seeded and scores -inf.

A call that autograd will not differentiate runs K4 alone and scores
``lse(beta[0] + I[0])``.  Otherwise ``_FccPallas`` runs K3 forward, which
keeps alpha and beta, and K5 backward:
    dI = softmax(alpha + beta) * g                          (per frame)
    dT = (sum_{t,b} u^T v) * E,  v = exp(alpha[t-1] - m_{t-1}),
         u = dI * exp(where(alpha finite, I - alpha, -inf) + m_{t-1} + c).
u's exponent is bounded by the transition spread, which the 60-nat guard of
``asg.py`` polices.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/fcc.cu``; on CPU tensors they run the plain versions beside them,
step-by-step loops of the same arithmetic.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .bigvocab_kernels import _exp_mats
from .common import (KERNEL_DTYPES, c_function, check_tensor, ptr,
                     raise_on_error, stream_ptr, use_kernel, wants_grad)
from ..semiring import NEG_INF, logsumexp

# Widest label set the kernels' one-thread-per-label block takes (the
# per-lattice tier's cap in ``asg.py``).
PER_LATTICE_MAX_WIDTH = 512


def _prepare(transition, inputs, input_lengths):
    """(E = exp(T - c), c as a 0-d tensor, contiguous inputs, int32 lengths)."""
    e, c = _exp_mats(transition, inputs.dtype)
    li = input_lengths.to(device=inputs.device, dtype=torch.int32)
    return e, c, inputs.contiguous(), li


def _lse_step(x, mat, c):
    """m-normalised exp-matmul logsumexp: lse_j(x[b, j] + log mat[j, i]) + c."""
    m = torch.amax(x, dim=1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m_safe + torch.log(torch.exp(x - m_safe) @ mat) + c


def _beta_rows(e, c, inputs, li):
    """The beta chain (T, B, N), t descending: the "I[T]" row is -inf, so
    frame T - 1 is the seed or -inf."""
    t_total = inputs.shape[0]
    out = torch.empty_like(inputs)
    zeros = torch.zeros_like(inputs[0])
    b = torch.where(li - 1 == t_total - 1, zeros, NEG_INF)
    out[t_total - 1] = b
    for t in range(t_total - 2, -1, -1):
        i_next = inputs[t + 1].masked_fill(~(li > t + 1), NEG_INF)
        raw = _lse_step(i_next + b, e, c)
        b = torch.where(li - 1 == t, zeros, raw)
        out[t] = b
    return out


def fcc_fwd_plain(e, c, inputs, input_lengths):
    """Plain version of K3: (alpha, beta), each (T, B, N), log domain."""
    li = input_lengths.to(device=inputs.device, dtype=torch.long)[:, None]
    alpha = torch.empty_like(inputs)
    e_t = e.T
    a = None
    for t in range(inputs.shape[0]):
        i_t = inputs[t].masked_fill(~(li > t), NEG_INF)
        a = i_t if t == 0 else i_t + _lse_step(a, e_t, c)
        alpha[t] = a
    return alpha, _beta_rows(e, c, inputs, li)


def fcc_beta_plain(e, c, inputs, input_lengths):
    """Plain version of K4: beta (T, B, N), log domain."""
    li = input_lengths.to(device=inputs.device, dtype=torch.long)[:, None]
    return _beta_rows(e, c, inputs, li)


def fcc_bwd_plain(e, c, inputs, input_lengths, alpha, beta, g):
    """Plain version of K5: (dI (T, B, N), dT (N, N)).

    Walks t from 0 up: the posterior dI_t = softmax(alpha_t + beta_t) * g
    (all--inf rows give zeros), and acc += u_t^T v_t with v_t the previous
    alpha row exponentiated against its own max (zeros at t = 0); after the
    walk dT = acc * E."""
    li = input_lengths.to(device=inputs.device, dtype=torch.long)[:, None]
    g = g.to(inputs.dtype)[:, None]
    gi_all = torch.empty_like(inputs)
    acc = torch.zeros_like(e)
    a_prev = torch.full_like(inputs[0], NEG_INF)
    for t in range(inputs.shape[0]):
        a_cur = alpha[t]
        gamma = a_cur + beta[t]
        m = torch.amax(gamma, dim=1, keepdim=True)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        ex = torch.exp(gamma - m_safe)
        denom = torch.sum(ex, dim=1, keepdim=True)
        gi = ex / torch.where(denom == 0.0, torch.ones_like(denom), denom) * g
        gi_all[t] = gi
        i_t = inputs[t].masked_fill(~(li > t), NEG_INF)
        mp = torch.amax(a_prev, dim=1, keepdim=True)
        mp_safe = torch.where(torch.isfinite(mp), mp, torch.zeros_like(mp))
        v = torch.exp(a_prev - mp_safe)
        u_expo = torch.where(torch.isfinite(a_cur), i_t - a_cur, NEG_INF)
        u = gi * torch.exp(u_expo + mp_safe + c)
        acc += u.T @ v
        a_prev = a_cur
    return gi_all, acc * e


def _check(e, c, inputs, li):
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"FCC kernels take float32 or float64, got {dt}")
    if num_labels > PER_LATTICE_MAX_WIDTH:
        raise ValueError(f"FCC kernels take num_labels <= {PER_LATTICE_MAX_WIDTH}; "
                         f"got {num_labels}")
    check_tensor("e", e, dt, (num_labels, num_labels), dev)
    check_tensor("c", c, dt, (), dev)
    check_tensor("inputs", inputs, dt, (t_total, num_batches, num_labels), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)


def fcc_fwd_pallas(e, c, inputs, input_lengths):
    """(alpha, beta), each (T, B, N): K3 on CUDA tensors, its plain version
    on CPU ones.  ``fcc_fwd_pallas.launches`` counts the kernel's launches."""
    if not use_kernel(inputs, e, c, input_lengths):
        return fcc_fwd_plain(e, c, inputs, input_lengths)
    li = input_lengths.to(torch.int32).contiguous()
    e = e.contiguous()
    _check(e, c, inputs, li)
    t_total, num_batches, num_labels = inputs.shape
    alpha, beta = torch.empty_like(inputs), torch.empty_like(inputs)
    if alpha.numel() == 0:
        return alpha, beta
    e_t = e.T.contiguous()
    fn = c_function("fcc", "fcc_fwd", inputs.dtype, 7, 3)
    dev = inputs.device
    with torch.cuda.device(dev):
        err = fn(ptr(inputs), ptr(e), ptr(e_t), ptr(c), ptr(li), ptr(alpha), ptr(beta),
                 t_total, num_batches, num_labels, stream_ptr(dev))
    raise_on_error(fn.__name__, err)
    fcc_fwd_pallas.launches += 1
    return alpha, beta


def fcc_beta_pallas(e, c, inputs, input_lengths):
    """beta (T, B, N): K4 on CUDA tensors, its plain version on CPU ones.
    ``fcc_beta_pallas.launches`` counts the kernel's launches."""
    if not use_kernel(inputs, e, c, input_lengths):
        return fcc_beta_plain(e, c, inputs, input_lengths)
    li = input_lengths.to(torch.int32).contiguous()
    e = e.contiguous()
    _check(e, c, inputs, li)
    t_total, num_batches, num_labels = inputs.shape
    beta = torch.empty_like(inputs)
    if beta.numel() == 0:
        return beta
    fn = c_function("fcc", "fcc_beta", inputs.dtype, 5, 3)
    dev = inputs.device
    with torch.cuda.device(dev):
        err = fn(ptr(inputs), ptr(e), ptr(c), ptr(li), ptr(beta),
                 t_total, num_batches, num_labels, stream_ptr(dev))
    raise_on_error(fn.__name__, err)
    fcc_beta_pallas.launches += 1
    return beta


def fcc_bwd_pallas(e, c, inputs, input_lengths, alpha, beta, g):
    """(dI (T, B, N), dT (N, N)): K5 on CUDA tensors, its plain version on
    CPU ones.  The per-element (N, N) transition partials go to a (B, N, N)
    scratch that a second kernel sums in a fixed order, so two runs give the
    same bits.  ``fcc_bwd_pallas.launches`` counts the kernel's launches."""
    if not use_kernel(inputs, e, c, input_lengths, alpha, beta, g):
        return fcc_bwd_plain(e, c, inputs, input_lengths, alpha, beta, g)
    li = input_lengths.to(torch.int32).contiguous()
    e = e.contiguous()
    _check(e, c, inputs, li)
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    g = g.to(dt).contiguous()
    check_tensor("alpha", alpha, dt, inputs.shape, dev)
    check_tensor("beta", beta, dt, inputs.shape, dev)
    check_tensor("g", g, dt, (num_batches,), dev)
    gi = torch.empty_like(inputs)
    d_trans = torch.empty_like(e)
    if gi.numel() == 0:
        return gi, d_trans.zero_()
    part = torch.empty((num_batches, num_labels, num_labels), dtype=dt, device=dev)
    fn = c_function("fcc", "fcc_bwd", dt, 10, 3)
    with torch.cuda.device(dev):
        err = fn(ptr(inputs), ptr(e), ptr(c), ptr(li), ptr(alpha), ptr(beta), ptr(g),
                 ptr(gi), ptr(part), ptr(d_trans), t_total, num_batches, num_labels,
                 stream_ptr(dev))
    raise_on_error(fn.__name__, err)
    fcc_bwd_pallas.launches += 1
    return gi, d_trans


def _score(beta0, inputs0):
    # every path starts at t = 0, which is valid for every seeded element
    return logsumexp(beta0 + inputs0, dim=1)


class _FccPallas(torch.autograd.Function):
    """K3 forward (alpha and beta kept), K5 backward."""

    @staticmethod
    def forward(ctx, transition, inputs, input_lengths):
        e, c, inputs, li = _prepare(transition, inputs, input_lengths)
        alpha, beta = fcc_fwd_pallas(e, c, inputs, li)
        ctx.save_for_backward(e, c, inputs, li, alpha, beta)
        return _score(beta[0], inputs[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        e, c, inputs, li, alpha, beta = ctx.saved_tensors
        grad_inputs, grad_transition = fcc_bwd_pallas(e, c, inputs, li, alpha, beta, g)
        return grad_transition, grad_inputs, None


def fcc_score_pallas(transition: torch.Tensor, inputs: torch.Tensor,
                     input_lengths: torch.Tensor) -> torch.Tensor:
    """Per-lattice denominator scores, shape (B,); same contract as
    ``ops.fcc.fcc_score``.  A call that autograd will not differentiate runs
    K4 alone; otherwise K3 forward and K5 backward."""
    transition = transition.to(inputs.dtype)
    if wants_grad(transition, inputs):
        return _FccPallas.apply(transition, inputs, input_lengths)
    e, c, inputs, li = _prepare(transition, inputs, input_lengths)
    beta = fcc_beta_pallas(e, c, inputs, li)
    return _score(beta[0], inputs[0])


fcc_fwd_pallas.launches = 0
fcc_beta_pallas.launches = 0
fcc_bwd_pallas.launches = 0
