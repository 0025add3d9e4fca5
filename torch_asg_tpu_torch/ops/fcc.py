"""Fully-connected (denominator) lattice: log-partition scores, forward only.

Per batch element, the log-semiring sum over ALL label paths of length
``input_lengths[b]`` through the (T, N) emission lattice with an (N, N)
transition matrix, where ``transition[i, j]`` scores a move from label j to
label i.  This is the log-domain scan tier (``impl='scan'``): exact for any
finite transition magnitudes, and the oracle every exp-domain tier is held
against.  Gradients land with the training slice.
"""

from __future__ import annotations

import torch

from .semiring import NEG_INF, logsumexp
from ..utils.lengths import mask_emissions


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


def fcc_score(
    transition: torch.Tensor, inputs: torch.Tensor, input_lengths: torch.Tensor
) -> torch.Tensor:
    """Log-partition (denominator) scores, shape (B,).

    transition: (N, N) with [i, j] = score of j -> i.
    inputs: (T, B, N) emission scores.  input_lengths: (B,) int.
    """
    inputs_m = mask_emissions(inputs, input_lengths)
    beta = _beta_scan(transition.to(inputs.dtype), inputs_m, input_lengths)
    return _score_from_beta(beta[0], inputs_m[0])
