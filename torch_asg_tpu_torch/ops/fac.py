"""Force-aligned (numerator) lattice: aligned-path scores and gradients.

The log-semiring sum over all monotonic alignments of
``targets[b, :target_lengths[b]]`` to the frames ``0 .. input_lengths[b]-1``:
each frame either stays on the current target slot (``transition[y_s, y_s]``)
or advances to the next one (``transition[y_{s+1}, y_s]``), emitting
``inputs[t, b, y_s]``.

``fac_score`` runs the beta scan only, unless autograd will ask for a
gradient: then it runs ``_FacScore``, a ``torch.autograd.Function`` whose
forward runs the alpha scan too.  The
backward recomputes the 2-way edge softmax from alpha,
    hori[t,b,s] = exp(alpha[t-1,b,s]   + selfT[b,s]   + I~[t,b,s] - alpha[t,b,s])
    diag[t,b,s] = exp(alpha[t-1,b,s-1] + nextT[b,s-1] + I~[t,b,s] - alpha[t,b,s])
(exponents <= 0), so no (T, 2, B, S) path tensor is stored, and
``scatter_to_full`` maps the aligned-domain gradients back to (T, B, N) and
(N, N) without atomics, so they are deterministic on every device.

The gathers are plain indexing (``torch.gather`` and advanced indexing),
deterministic on every device; their semantics are the reference's:
targets clip into [0, N), gathered emissions are -inf outside
``t < L_in and s < L_out``, ``next_trans`` is 0 from slot ``L_out - 1`` on,
and -inf transitions pass through.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .kernels.common import wants_grad
from .semiring import NEG_INF, logaddexp, masked_softmax
from ..utils.lengths import label_mask, time_mask

# Widest vocabulary for which the scatters run as (B, S, N) one-hot
# products; past it, a loop over target slots (no O(N) memory per slot).
_ONEHOT_MAX_LABELS = 512


class AlignedLattice(NamedTuple):
    """Gathered, aligned-domain views of the emissions and transitions."""

    inputs: torch.Tensor  # (T, B, S); -inf outside t < L_in[b] and s < L_out[b]
    self_trans: torch.Tensor  # (B, S); T[y_s, y_s], 0 where s >= L_out[b]
    next_trans: torch.Tensor  # (B, S); T[y_{s+1}, y_s], 0 where s >= L_out[b]-1
    targets: torch.Tensor  # (B, S) clipped into [0, N)


def gather_aligned_emissions(inputs, tgt, tmask, smask):
    """(T, B, S) gather ``I~[t,b,s] = I[t,b,tgt[b,s]]``, -inf outside
    ``tmask & smask``.  Non-finite emissions gather as -inf, as the
    reference's sentinel-guarded one-hot gather gives them."""
    idx = tgt[None].expand(inputs.shape[0], -1, -1)
    aligned = torch.gather(inputs, 2, idx)
    valid = tmask[:, :, None] & smask[None, :, :] & torch.isfinite(aligned)
    return aligned.masked_fill(~valid, NEG_INF)


def make_aligned(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
) -> AlignedLattice:
    t_total, num_batches, num_labels = inputs.shape
    s_total = targets.shape[1]
    tgt = targets.long().clamp(0, num_labels - 1)
    tmask = time_mask(t_total, input_lengths)  # (T, B)
    smask = label_mask(s_total, target_lengths)  # (B, S)
    aligned = gather_aligned_emissions(inputs, tgt, tmask, smask)

    zero = torch.zeros((), dtype=inputs.dtype, device=inputs.device)
    transition = transition.to(inputs.dtype)
    self_trans = torch.where(smask, transition[tgt, tgt], zero)
    next_pairs = transition[tgt[:, 1:], tgt[:, :-1]]  # T[y_{s+1}, y_s]
    next_trans = torch.cat([next_pairs, zero.expand(num_batches, 1)], dim=1)
    next_valid = label_mask(s_total, target_lengths - 1)
    next_trans = torch.where(next_valid, next_trans, zero)
    return AlignedLattice(aligned, self_trans, next_trans, tgt)


def _shift_right_s(x: torch.Tensor, fill: float = NEG_INF) -> torch.Tensor:
    """Shift along the last (s) axis so slot s holds the old slot s-1."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def _shift_left_s(x: torch.Tensor, fill: float = NEG_INF) -> torch.Tensor:
    """Shift along the last (s) axis so slot s holds the old slot s+1."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., 1:], pad], dim=-1)


def _alpha_scan(lat: AlignedLattice) -> torch.Tensor:
    """alpha (T, B, S) in the log domain, seeded at s = 0 only: every other
    slot starts inaccessible."""
    t_total, num_batches, s_total = lat.inputs.shape
    a = torch.full((num_batches, s_total), NEG_INF, dtype=lat.inputs.dtype,
                   device=lat.inputs.device)
    a[:, 0] = lat.inputs[0, :, 0]
    rows = [a]
    for t in range(1, t_total):
        hori = a + lat.self_trans
        diag = _shift_right_s(a + lat.next_trans)
        a = lat.inputs[t] + logaddexp(hori, diag)
        rows.append(a)
    return torch.stack(rows)


def _beta_scan(
    lat: AlignedLattice, input_lengths: torch.Tensor, target_lengths: torch.Tensor
) -> torch.Tensor:
    """beta (T, B, S) in the log domain, seeded 0 at (L_in-1, L_out-1); the
    seed frame's own emission is not included."""
    t_total, num_batches, s_total = lat.inputs.shape
    s_idx = torch.arange(s_total, device=lat.inputs.device)
    seed = torch.full((num_batches, s_total), NEG_INF, dtype=lat.inputs.dtype,
                      device=lat.inputs.device)
    seed = seed.masked_fill(s_idx[None, :] == (target_lengths - 1)[:, None], 0.0)
    neg = torch.full_like(seed, NEG_INF)
    b_next = torch.where((input_lengths == t_total)[:, None], seed, neg)
    rows = [b_next]
    for t in range(t_total - 2, -1, -1):
        i_next = lat.inputs[t + 1]
        hori = lat.self_trans + i_next + b_next
        diag = lat.next_trans + _shift_left_s(i_next + b_next)
        raw = logaddexp(hori, diag)
        b_next = torch.where((input_lengths - 1 == t)[:, None], seed, raw)
        rows.append(b_next)
    return torch.stack(rows[::-1])


def _score(beta0: torch.Tensor, aligned0: torch.Tensor) -> torch.Tensor:
    # Every aligned path starts at (t=0, s=0).
    return beta0[:, 0] + aligned0[:, 0]


def aligned_domain_grads(lat: AlignedLattice, alpha, beta, g):
    """(g_aligned, g_self_trans, g_next_trans) in the aligned domain, from
    the recomputed 2-way edge softmax.  ``sub`` guards -inf - -inf = NaN:
    a finite alpha implies a finite aligned input."""
    g_aligned = masked_softmax(alpha + beta, dim=2) * g[None, :, None]  # (T, B, S)

    sub = torch.where(torch.isfinite(alpha), lat.inputs - alpha, NEG_INF)
    hori = torch.exp(alpha[:-1] + lat.self_trans[None] + sub[1:])
    diag = torch.exp(_shift_right_s(alpha[:-1] + lat.next_trans[None]) + sub[1:])

    gi_tail = g_aligned[1:]  # contributions for t >= 1
    # s = 0 has only the self-loop in-edge, factor 1
    edge_self = torch.cat([torch.ones_like(hori[:, :, :1]), hori[:, :, 1:]], dim=2)
    g_self_trans = torch.sum(gi_tail * edge_self, dim=0)  # (B, S)
    # next_trans[b, s] feeds slot s+1: shift the diagonal mass down by one
    g_next_trans = _shift_left_s(torch.sum(gi_tail * diag, dim=0), fill=0.0)
    return g_aligned, g_self_trans, g_next_trans


def _pair_sums(onehot, g_self_trans, g_next_trans):
    """dT[i,j] = sum_{b,s} 1[y_s = i] g_self[b,s] 1[y_s = j]
               + sum_{b,s} 1[y_{s+1} = i] g_next[b,s] 1[y_s = j]."""
    gt_self = torch.einsum("bsi,bs,bsj->ij", onehot, g_self_trans, onehot)
    gt_next = torch.einsum("bsi,bs,bsj->ij", onehot[:, 1:], g_next_trans[:, :-1],
                           onehot[:, :-1])
    return gt_self + gt_next


def scatter_to_full(
    lat: AlignedLattice,
    g_aligned: torch.Tensor,
    g_self_trans: torch.Tensor,
    g_next_trans: torch.Tensor,
    num_labels: int,
):
    """(grad_transition (N, N), grad_inputs (T, B, N)) from the aligned-domain
    gradients.  Masked-out slots carry exact zeros, so the scatters are
    unconditional.  No arm uses atomics (``index_add_`` and ``scatter_add_``
    do on CUDA), so the result is the same from run to run:

    * up to ``_ONEHOT_MAX_LABELS`` labels, one-hot products;
    * past it, the emission gradients add one target slot at a time: within
      one slot the B target labels fall in distinct rows b, so no two
      writes meet.  The transition gradients are the one-hot product over
      the labels that occur in ``targets`` (at most B * S of them), written
      back into the (N, N) matrix at distinct positions.
    """
    tgt = lat.targets
    dt = g_aligned.dtype
    if num_labels <= _ONEHOT_MAX_LABELS:
        onehot = F.one_hot(tgt, num_labels).to(dt)  # (B, S, N)
        grad_inputs = torch.einsum("bsi,tbs->tbi", onehot, g_aligned)
        return _pair_sums(onehot, g_self_trans, g_next_trans), grad_inputs

    t_total, num_batches, s_total = g_aligned.shape
    grad_inputs = g_aligned.new_zeros((t_total, num_batches, num_labels))
    rows = torch.arange(num_batches, device=tgt.device)
    for s in range(s_total):
        grad_inputs[:, rows, tgt[:, s]] += g_aligned[:, :, s]
    labels, compact = torch.unique(tgt, sorted=True, return_inverse=True)
    small = _pair_sums(F.one_hot(compact, labels.numel()).to(dt),
                       g_self_trans, g_next_trans)
    grad_transition = g_aligned.new_zeros((num_labels, num_labels))
    grad_transition[labels[:, None], labels[None, :]] = small
    return grad_transition, grad_inputs


def _primal(transition, inputs, targets, input_lengths, target_lengths):
    """(aligned lattice, beta, scores)."""
    lat = make_aligned(transition, inputs, targets, input_lengths, target_lengths)
    beta = _beta_scan(lat, input_lengths, target_lengths)
    return lat, beta, _score(beta[0], lat.inputs[0])


class _FacScore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, transition, inputs, targets, input_lengths, target_lengths):
        lat, beta, score = _primal(transition, inputs, targets, input_lengths,
                                   target_lengths)
        ctx.save_for_backward(*lat, _alpha_scan(lat), beta)
        ctx.num_labels = inputs.shape[2]
        return score

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        *fields, alpha, beta = ctx.saved_tensors
        lat = AlignedLattice(*fields)
        grads = aligned_domain_grads(lat, alpha, beta, g)
        grad_transition, grad_inputs = scatter_to_full(lat, *grads, ctx.num_labels)
        return grad_transition, grad_inputs, None, None, None


def fac_score(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
) -> torch.Tensor:
    """Force-aligned (numerator) scores, shape (B,); log-domain scan,
    differentiable in ``transition`` and ``inputs``."""
    transition = transition.to(inputs.dtype)
    if wants_grad(transition, inputs):
        return _FacScore.apply(transition, inputs, targets, input_lengths,
                               target_lengths)
    return _primal(transition, inputs, targets, input_lengths, target_lengths)[2]
