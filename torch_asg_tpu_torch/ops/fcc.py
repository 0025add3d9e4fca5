"""Fully-connected (denominator) lattice: log-partition scores and gradients.

Per batch element, the log-semiring sum over ALL label paths of length
``input_lengths[b]`` through the (T, N) emission lattice with an (N, N)
transition matrix, where ``transition[i, j]`` scores a move from label j to
label i.  This is the log-domain scan tier (``impl='scan'``): exact for any
finite transition magnitudes, and the oracle every exp-domain tier is held
against.

``fcc_score`` runs the beta scan only, unless autograd will ask for a
gradient: then it runs ``_FccScore``, a ``torch.autograd.Function`` whose
forward runs the alpha scan too.  Its backward takes the gradients from the
posterior marginals gamma = alpha + beta and recomputes the per-step
transition softmax from alpha,
    softmax_j(T[i,j] + I[t,b,i] + alpha[t-1,b,j])
      = exp(T[i,j] + alpha[t-1,b,j] + I[t,b,i] - alpha[t,b,i]),
whose exponent is <= 0, so no (T, B, N, N) path tensor is ever stored.

``fcc_score_matmul`` is the matmul tier (``impl='matmul'``) for wordpiece
vocabularies: each step's logsumexp over transitions becomes one (B, N) x
(N, N) product with the max-normalised ``exp(T - c)`` matrix,
    lse_j(T[i,j] + a[j]) = c + m + log(exp(a - m) @ exp(T - c)^T)[i],
so a step needs O(B N + N^2) memory instead of the scan's (B, N, N).  Under
autograd its forward runs both chains; on CUDA tensors the dual-stream
kernel K9 (``kernels/bigvocab_kernels.py``) runs them in one pass over the
matrix per paired step.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd.function import once_differentiable

from .kernels.bigvocab_kernels import _exp_mats, fcc_dual_streams
from .kernels.common import wants_grad
from .semiring import (NEG_INF, chain_precision, logsumexp, masked_softmax,
                       strict_chain_precision)
from ..utils.lengths import mask_emissions


def _alpha_scan(transition: torch.Tensor, inputs_m: torch.Tensor) -> torch.Tensor:
    """alpha (T, B, N): alpha[0] = I[0];
    alpha[t, b, i] = I[t, b, i] + lse_j(T[i, j] + alpha[t-1, b, j]).
    Invalid frames (I = -inf) make alpha -inf from there on, which the
    backward's masked softmax turns into exact zeros."""
    a = inputs_m[0]
    rows = [a]
    for t in range(1, inputs_m.shape[0]):
        pc = transition[None, :, :] + a[:, None, :]  # (B, N_to, N_from)
        a = inputs_m[t] + logsumexp(pc, dim=2)
        rows.append(a)
    return torch.stack(rows)


def _beta_scan(
    transition: torch.Tensor, inputs_m: torch.Tensor, input_lengths: torch.Tensor
) -> torch.Tensor:
    """beta (T, B, N), seeded 0 per batch at t == L_in[b]-1; for t < L_in-1:
    beta[t, b, i] = lse_j(T[j, i] + I[t+1, b, j] + beta[t+1, b, j])."""
    t_total, num_batches, num_labels = inputs_m.shape
    trans_t = transition.T
    zeros = torch.zeros((num_batches, num_labels), dtype=inputs_m.dtype,
                        device=inputs_m.device)
    b_next = torch.where((input_lengths == t_total)[:, None], zeros, NEG_INF)
    rows = [b_next]
    for t in range(t_total - 2, -1, -1):
        contrib = (inputs_m[t + 1] + b_next)[:, None, :]  # (B, 1, N_from)
        raw = logsumexp(trans_t[None, :, :] + contrib, dim=2)
        b_next = torch.where((input_lengths - 1 == t)[:, None], zeros, raw)
        rows.append(b_next)
    return torch.stack(rows[::-1])


def _score_from_beta(beta0: torch.Tensor, inputs0: torch.Tensor) -> torch.Tensor:
    # score_b = lse_i(beta[0, b, i] + I[0, b, i]); t = 0 is always valid.
    return logsumexp(beta0 + inputs0, dim=1)


def _fcc_bwd(transition, inputs_m, alpha, beta, g):
    """(grad_transition, grad_inputs) from the marginals."""
    # d score_b / d I[t, b, i] = posterior marginal of being at (t, i)
    grad_inputs = masked_softmax(alpha + beta, dim=2) * g[None, :, None]
    # d score_b / d T[i, j] = sum_{t>=1} gI[t,b,i] * softmax_j(path[t,b,i,:])
    acc = torch.zeros_like(transition)
    for t in range(1, inputs_m.shape[0]):
        a_cur = alpha[t]
        sub = torch.where(torch.isfinite(a_cur), inputs_m[t] - a_cur, NEG_INF)
        expo = transition[None, :, :] + alpha[t - 1][:, None, :] + sub[:, :, None]
        acc = acc + torch.einsum("bi,bij->ij", grad_inputs[t], torch.exp(expo))
    return acc, grad_inputs


def _primal(transition, inputs, input_lengths):
    """(masked emissions, beta, scores)."""
    inputs_m = mask_emissions(inputs, input_lengths)
    beta = _beta_scan(transition, inputs_m, input_lengths)
    return inputs_m, beta, _score_from_beta(beta[0], inputs_m[0])


class _FccScore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, transition, inputs, input_lengths):
        inputs_m, beta, score = _primal(transition, inputs, input_lengths)
        alpha = _alpha_scan(transition, inputs_m)
        ctx.save_for_backward(transition, inputs_m, alpha, beta)
        return score

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grad_transition, grad_inputs = _fcc_bwd(*ctx.saved_tensors, g)
        return grad_transition, grad_inputs, None


def fcc_score(
    transition: torch.Tensor, inputs: torch.Tensor, input_lengths: torch.Tensor
) -> torch.Tensor:
    """Log-partition (denominator) scores, shape (B,); differentiable in
    ``transition`` and ``inputs``.

    transition: (N, N) with [i, j] = score of j -> i.
    inputs: (T, B, N) emission scores.  input_lengths: (B,) int.
    """
    transition = transition.to(inputs.dtype)
    if wants_grad(transition, inputs):
        return _FccScore.apply(transition, inputs, input_lengths)
    return _primal(transition, inputs, input_lengths)[2]


# --- the matmul tier ---------------------------------------------------------


def _lse_mm(x, mat, c):
    """``lse_j(x[b, j] + log mat[j, i]) + c``, -inf-safe in value and
    gradient: a dead row (s == 0) stays -inf, and the double-where keeps its
    gradient finite (a bare ``log(s)`` would give 0 * (1/0) = NaN)."""
    m = torch.amax(x, dim=1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(x - m_safe) @ mat
    alive = s > 0
    out = torch.where(alive, torch.log(torch.where(alive, s, torch.ones_like(s))),
                      NEG_INF)
    return out + m_safe + c


def _alpha_scan_mm(transition, inputs_m):
    """alpha (T, B, N) of ``_alpha_scan``, one (B, N) x (N, N) product a step."""
    e, c = _exp_mats(transition, inputs_m.dtype)
    e_t = e.T
    a = inputs_m[0]
    rows = [a]
    for t in range(1, inputs_m.shape[0]):
        a = inputs_m[t] + _lse_mm(a, e_t, c)
        rows.append(a)
    return torch.stack(rows)


def _beta_scan_mm(transition, inputs_m, input_lengths):
    """beta (T, B, N) of ``_beta_scan``, one (B, N) x (N, N) product a step."""
    e, c = _exp_mats(transition, inputs_m.dtype)
    t_total = inputs_m.shape[0]
    zeros = torch.zeros(inputs_m.shape[1:], dtype=inputs_m.dtype, device=inputs_m.device)
    b_next = torch.where((input_lengths == t_total)[:, None], zeros, NEG_INF)
    rows = [b_next]
    for t in range(t_total - 2, -1, -1):
        raw = _lse_mm(inputs_m[t + 1] + b_next, e, c)
        b_next = torch.where((input_lengths - 1 == t)[:, None], zeros, raw)
        rows.append(b_next)
    return torch.stack(rows[::-1])


# Which formulation computes the two chains under autograd: None elects by
# ``_resolve_dual``'s rule; True or False forces the dual-stream kernel or
# the two scans (tests hold the two against each other).
_DUAL_OVERRIDE = None


@contextlib.contextmanager
def force_dual_streams(value: bool = True):
    global _DUAL_OVERRIDE
    prev = _DUAL_OVERRIDE
    _DUAL_OVERRIDE = value
    try:
        yield
    finally:
        _DUAL_OVERRIDE = prev


def _resolve_dual(inputs) -> bool:
    """Elect the dual-stream kernel K9 for the matmul tier's two chains.

    By default it runs on CUDA tensors at 'default' chain precision; under
    'highest' the two scans run, so a strict check holds the kernel against
    an independent formulation; CPU tensors run the scans unless
    ``force_dual_streams(True)``, which runs K9's plain version.  T = 1 has
    no chain to pair."""
    use_dual = _DUAL_OVERRIDE
    if use_dual is None:
        use_dual = inputs.is_cuda and chain_precision() == "default"
    return bool(use_dual and inputs.shape[0] > 1)


def _mm_streams(dual, transition, inputs_m, input_lengths):
    """(alpha, beta) for the matmul tier: K9, or the two scans."""
    if dual:
        return fcc_dual_streams(transition, inputs_m, input_lengths)
    return (_alpha_scan_mm(transition, inputs_m),
            _beta_scan_mm(transition, inputs_m, input_lengths))


def _fcc_mm_bwd(transition, inputs_m, alpha, beta, g):
    """(grad_transition, grad_inputs) of the matmul tier, from the marginals.

    dT[i,j] = e[i,j] * sum_{t,b} U[t,b,i] V[t,b,j] with V = exp(a_prev - m)
    and U = gI * exp(I - a_cur + m + c): both are built for all steps at
    once and contracted in ONE (N, TB) x (TB, N) product, so no (N, N)
    accumulator is rewritten per step."""
    grad_inputs = masked_softmax(alpha + beta, dim=2) * g[None, :, None]
    e, c = _exp_mats(transition, inputs_m.dtype)
    m = torch.amax(alpha[:-1], dim=2, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    v = torch.exp(alpha[:-1] - m_safe)
    sub = torch.where(torch.isfinite(alpha[1:]), inputs_m[1:] - alpha[1:], NEG_INF)
    # The exponent is bounded by the transition's spread (c is the global
    # max, not the row's own path), so it is not provably <= 0: clamp it
    # below the fp32 overflow point, so a >60-nat spread under
    # validate=False gives a clamped, finite gradient and not inf * 0 = NaN.
    u = grad_inputs[1:] * torch.exp(torch.clamp(sub + m_safe + c, max=60.0))
    n = u.shape[2]
    acc = u.reshape(-1, n).T @ v.reshape(-1, n)
    return (acc * e).to(transition.dtype), grad_inputs


class _FccMatmul(torch.autograd.Function):
    """Both chains forward (K9 or the scans, as elected), the factor-form
    gradient backward, both at the chain precision the caller captured."""

    @staticmethod
    def forward(ctx, transition, inputs, input_lengths, precision, dual):
        with strict_chain_precision(precision):
            inputs_m = mask_emissions(inputs, input_lengths)
            alpha, beta = _mm_streams(dual, transition, inputs_m, input_lengths)
        ctx.precision = precision
        ctx.save_for_backward(transition, inputs_m, alpha, beta)
        return _score_from_beta(beta[0], inputs_m[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with strict_chain_precision(ctx.precision):
            grad_transition, grad_inputs = _fcc_mm_bwd(*ctx.saved_tensors, g)
        return grad_transition, grad_inputs, None, None, None


def fcc_score_matmul(
    transition: torch.Tensor, inputs: torch.Tensor, input_lengths: torch.Tensor
) -> torch.Tensor:
    """``fcc_score`` through the matmul formulation: same contract, for
    vocabularies too wide for the (B, N, N) scan step.

    A call that autograd will not differentiate runs the beta chain alone.
    The chain precision in force here, and with it the dual-stream
    election, is captured for the backward too."""
    transition = transition.to(inputs.dtype)
    precision = chain_precision()
    if wants_grad(transition, inputs):
        return _FccMatmul.apply(transition, inputs, input_lengths, precision,
                                _resolve_dual(inputs))
    inputs_m = mask_emissions(inputs, input_lengths)
    beta = _beta_scan_mm(transition, inputs_m, input_lengths)
    return _score_from_beta(beta[0], inputs_m[0])
