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
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .kernels.common import wants_grad
from .semiring import NEG_INF, logsumexp, masked_softmax
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
