"""Force-aligned (numerator) lattice: aligned-path scores, forward only.

The log-semiring sum over all monotonic alignments of
``targets[b, :target_lengths[b]]`` to the frames ``0 .. input_lengths[b]-1``:
each frame either stays on the current target slot (``transition[y_s, y_s]``)
or advances to the next one (``transition[y_{s+1}, y_s]``), emitting
``inputs[t, b, y_s]``.  Gradients land with the training slice.

The gathers are plain indexing (``torch.gather`` and advanced indexing),
deterministic on every device; their semantics are the reference's:
targets clip into [0, N), gathered emissions are -inf outside
``t < L_in and s < L_out``, ``next_trans`` is 0 from slot ``L_out - 1`` on,
and -inf transitions pass through.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .semiring import NEG_INF, logaddexp
from ..utils.lengths import label_mask, time_mask


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


def _shift_left_s(x: torch.Tensor, fill: float = NEG_INF) -> torch.Tensor:
    """Shift along the last (s) axis so slot s holds the old slot s+1."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., 1:], pad], dim=-1)


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


def fac_score(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
) -> torch.Tensor:
    """Force-aligned (numerator) scores, shape (B,); log-domain scan."""
    lat = make_aligned(transition, inputs, targets, input_lengths, target_lengths)
    beta = _beta_scan(lat, input_lengths, target_lengths)
    return _score(beta[0], lat.inputs[0])
