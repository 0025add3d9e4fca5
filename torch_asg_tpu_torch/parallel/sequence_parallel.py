"""Sequence-parallel (long-context) ASG: the time axis split over ranks.

The log semiring is associative, so the recursion over T decomposes
exactly:

  alpha_t = A_t (x) alpha_{t-1},     A_t[i, j] = I_t[i] + T[i, j]

and a contiguous block of frames composes into one transfer matrix
``M_p = A_last (x) ... (x) A_first``.  Each rank:

  1. builds its block's transfer matrix with a local scan that carries an
     (N, N) log-semiring matrix (an N-fold basis-vector recursion: xN work
     for xP parallelism, worth it when T alone exceeds one card's memory or
     latency budget);
  2. all-gathers the chunk matrices (``collectives.gather_blocks``, one
     all-gather of O(P B (N^2 + S^2)), independent of T);
  3. folds the prefix product into the final alpha boundary, as every
     other rank does, and reads the score off it.

Ragged lengths use a *frozen-identity* convention instead of -inf masking:
an invalid frame's step matrix is the semiring identity, so alpha freezes
at its ``t = L_in[b] - 1`` value and the final boundary IS ``alpha_{L-1}``
for every element.  The force-aligned lattice gets the same treatment with
(S, S) transfer matrices over its 2-edge band.

Chunk 0 is special (alpha_0 = I_0 is not A (x) v): rank 0 contributes a
plain vector scan and every other rank a matrix; the fold reads only
those, so each rank computes only its own.

Gradients flow through autograd over the chunk scans (each step
checkpointed, so a rank keeps O((T/P) B N^2) of residuals, not the steps'
(B, N, N, N) insides); the all-gather's backward hands each rank its own
slice of the gradient, and the replicated transition's gradient is
all-reduced once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from ..asg import REDUCTIONS, _prep, _reduce
from ..ops.fac import make_aligned
from ..ops.semiring import NEG_INF
from .collectives import check_blocks, gather_blocks, mesh_axis, replicated_input

# ---------------------------------------------------------------------------
# grad-safe log-semiring reductions (autograd runs through this module)
# ---------------------------------------------------------------------------


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """logsumexp whose gradient is NaN-free on all -inf slices."""
    m = torch.amax(x.detach(), dim=dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(x - m_safe).sum(dim)
    s_safe = torch.where(s == 0.0, torch.ones_like(s), s)
    m_sq = m.squeeze(dim)
    return torch.where(torch.isfinite(m_sq), torch.log(s_safe) + m_safe.squeeze(dim), m_sq)


def _logaddexp(a, b):
    return _lse(torch.stack([a, b]), 0)


def _log_eye(n: int, dtype, device) -> torch.Tensor:
    eye = torch.eye(n, dtype=torch.bool, device=device)
    return torch.zeros((n, n), dtype=dtype, device=device).masked_fill(~eye, NEG_INF)


def _shift_s(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift +1 along ``dim`` (slot s holds old slot s-1), fill -inf."""
    pad = torch.full_like(x.narrow(dim, 0, 1), NEG_INF)
    return torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def _scan(step, carry, *xs):
    """carry = step(carry, *x_t) over the leading axis of ``xs``, each step
    checkpointed under autograd (the step's closure may hold the tensors
    that require a gradient)."""
    grad = torch.is_grad_enabled()
    for x_t in zip(*xs):
        carry = (checkpoint(step, carry, *x_t, use_reentrant=False) if grad
                 else step(carry, *x_t))
    return carry


# ---------------------------------------------------------------------------
# local chunk programs
# ---------------------------------------------------------------------------


def _fcc_chunk(transition, inputs_c, valid_c, first: bool):
    """The FCC boundary of one block of frames: the chunk-0 alpha vector
    (B, N) when ``first``, else the transfer matrix (B, N, N) of the block's
    valid steps (invalid frames are the semiring identity)."""
    c_len, num_batches, num_labels = inputs_c.shape
    if first:
        def vstep(a, i_t, val):
            a_new = i_t + _lse(transition[None] + a[:, None, :], 2)
            return torch.where(val[:, None], a_new, a)

        a0 = torch.where(valid_c[0][:, None], inputs_c[0], NEG_INF)
        return _scan(vstep, a0, inputs_c[1:], valid_c[1:])

    def mstep(f, i_t, val):
        # A_t (x) F: out[b,i,j] = I_t[i] + lse_k(T[i,k] + F[b,k,j])
        comp = i_t[:, :, None] + _lse(transition[None, :, :, None] + f[:, None, :, :], 2)
        return torch.where(val[:, None, None], comp, f)

    f0 = _log_eye(num_labels, inputs_c.dtype, inputs_c.device).expand(num_batches, -1, -1)
    return _scan(mstep, f0, inputs_c, valid_c)


def _fac_chunk(aligned_c, self_t, next_t, valid_c, first: bool):
    """FAC twin of ``_fcc_chunk`` over the (S, S) aligned-state space."""
    c_len, num_batches, s_total = aligned_c.shape
    if first:
        def vstep(a, ai_t, val):
            a_new = ai_t + _logaddexp(a + self_t, _shift_s(a + next_t, 1))
            return torch.where(val[:, None], a_new, a)

        col = torch.arange(s_total, device=aligned_c.device)[None, :]
        a0 = torch.where((col == 0) & valid_c[0][:, None], aligned_c[0], NEG_INF)
        return _scan(vstep, a0, aligned_c[1:], valid_c[1:])

    def mstep(g, ai_t, val):
        hori = g + self_t[:, :, None]
        diag = _shift_s(g + next_t[:, :, None], 1)
        comp = ai_t[:, :, None] + _logaddexp(hori, diag)
        return torch.where(val[:, None, None], comp, g)

    g0 = _log_eye(s_total, aligned_c.dtype, aligned_c.device).expand(num_batches, -1, -1)
    return _scan(mstep, g0, aligned_c, valid_c)


def _fold_boundaries(v0, ms):
    """alpha boundary after the last chunk: M_{P-1} (x) ... (x) M_1 (x) v_0.

    v0: (B, N) chunk 0's vector; ms: the later chunks' (B, N, N) matrices,
    in order.  Replicated math, P-1 small matvecs."""
    v = v0
    for m in ms:
        v = _lse(m + v[:, None, :], 2)
    return v


def chunk_boundaries(transition, inputs_c, targets, input_lengths, target_lengths,
                     t0: int, first: bool):
    """(FCC boundary, FAC boundary) of the block of frames starting at
    ``t0``: vectors (B, N), (B, S) when ``first``, else matrices (B, N, N),
    (B, S, S)."""
    c_len = inputs_c.shape[0]
    t_idx = t0 + torch.arange(c_len, device=inputs_c.device)
    valid_c = t_idx[:, None] < input_lengths[None, :]  # (C, B)
    fcc = _fcc_chunk(transition, inputs_c, valid_c, first)
    # make_aligned masks by ABSOLUTE frame indices: give it the block with
    # the lengths clamped into the block's range
    li_local = torch.clamp(input_lengths - t0, 0, c_len)
    lat = make_aligned(transition, inputs_c, targets, li_local, target_lengths)
    return fcc, _fac_chunk(lat.inputs, lat.self_trans, lat.next_trans, valid_c, first)


def loss_from_boundaries(fcc, fac, target_lengths):
    """Per-element loss from every block's boundaries in frame order: the
    first block's vectors, then the others' matrices."""
    full = _lse(_fold_boundaries(fcc[0], fcc[1:]), 1)
    alpha_fac_end = _fold_boundaries(fac[0], fac[1:])  # (B, S)
    s_total = alpha_fac_end.shape[1]
    end = (target_lengths.long() - 1) % s_total  # a negative slot wraps, as in JAX
    return full - alpha_fac_end.gather(1, end[:, None])[:, 0]


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def asg_loss_seq(
    mesh: DeviceMesh,
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    *,
    axis: str = "seq",
    reduction: str = "mean",
) -> torch.Tensor:
    """ASG loss with the TIME axis split over ``mesh[axis]``.

    This rank passes its block of T/P frames (T/P, B, N) and the whole
    transition, targets and lengths (lengths count global frames).  One
    all-gather of (P, B, N^2 + N + S^2 + S) boundaries a call, independent
    of T.  Differentiable: the emission gradient is the rank's block of the
    single-process one, the transition gradient the whole of it.
    """
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}; expected one of {REDUCTIONS}")
    ax = mesh_axis(mesh, axis)
    c_len, num_batches, num_labels = inputs.shape
    t_total = check_blocks(c_len, ax, axis, "T", inputs.device)
    # asg_loss's front-end normalisation, against the GLOBAL T
    inputs, targets, input_lengths, target_lengths = _prep(
        inputs, targets, input_lengths, target_lengths, t_total)
    dev = inputs.device
    dt = torch.promote_types(inputs.dtype, transition.dtype)
    trans = replicated_input(transition.to(device=dev, dtype=dt), ax)
    inputs = inputs.to(dt)

    first = ax.index == 0
    fcc, fac = chunk_boundaries(trans, inputs, targets, input_lengths, target_lengths,
                                ax.index * c_len, first)
    # one all-gather of every rank's boundaries; the slots another rank's
    # kind of boundary would take are zeros that the fold never reads
    s_cut = targets.shape[1]
    n2, s2 = num_labels * num_labels, s_cut * s_cut
    parts = [fcc.new_zeros((num_batches, n2)), fcc.new_zeros((num_batches, num_labels)),
             fac.new_zeros((num_batches, s2)), fac.new_zeros((num_batches, s_cut))]
    parts[1 if first else 0] = fcc.reshape(num_batches, -1)
    parts[3 if first else 2] = fac.reshape(num_batches, -1)
    gathered = gather_blocks(torch.cat(parts, dim=1), ax)  # (P, B, K)
    m_fcc, v_fcc, m_fac, v_fac = gathered.split([n2, num_labels, s2, s_cut], dim=2)
    fcc_all = [v_fcc[0]] + [m.reshape(num_batches, num_labels, num_labels)
                            for m in m_fcc[1:]]
    fac_all = [v_fac[0]] + [m.reshape(num_batches, s_cut, s_cut) for m in m_fac[1:]]
    return _reduce(loss_from_boundaries(fcc_all, fac_all, target_lengths), reduction)
