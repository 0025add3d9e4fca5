"""Vocabulary-sharded ASG for large label sets (e.g. 10k wordpieces).

The (N, N) transition matrix is split by ROWS over the mesh's model axis
and the emissions along their label dim: each rank holds N/P rows and the
matching (T, B, N/P) emission block, and the FCC recursions keep only that
slice of alpha and beta, exchanging boundary state every step:

  * alpha step: all-gather the (B, N/P) alpha blocks -> contract the local
    transition rows over the full source axis;
  * beta step: contract the local source block of (I + beta) against the
    same rows, then combine the ranks' partial logsumexps with an
    all-reduce MAX and an all-reduce SUM;
  * the transition rows' gradient never leaves its rank and the emission
    gradient is local; the posteriors use sum_i exp(gamma[t,b,i]) =
    exp(score_b), so the backward needs no collective beyond the alpha
    all-gather (in chunks of ``_DT_CHUNK_T`` frames) and one MAX.

The force-aligned lattice is only (B, S), independent of the label count,
so every rank runs it whole after an all-reduce SUM gathers the per-target
emissions and transition entries; its gradients land in each rank's own
rows and labels.

``_AsgVP`` is a ``torch.autograd.Function`` whose forward and backward run
their collectives themselves: the loss it returns is replicated, every rank
receives the same gradient, and each turns it into the gradient of its own
blocks, so nothing is summed over the ranks.  The products run in full
float32 on CUDA (no TF32), as the port's other FCC products do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.distributed.device_mesh import DeviceMesh

from ..asg import REDUCTIONS, _prep, _reduce
from ..ops.fac import (AlignedLattice, _alpha_scan as _fac_alpha_scan,
                       _beta_scan as _fac_beta_scan, _pair_sums,
                       _score as _fac_score_readout, aligned_domain_grads)
from ..ops.semiring import (NEG_INF, chain_precision, ieee_fp32_products, logsumexp,
                            strict_chain_precision)
from ..utils.lengths import default_lengths, label_mask, mask_emissions, time_mask
from .collectives import Axis, all_reduce, mesh_axis

# ---------------------------------------------------------------------------
# collective helpers
# ---------------------------------------------------------------------------


def _lse_over_ranks(partial: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Elementwise logsumexp across the axis; -inf safe; replicated out."""
    m = all_reduce(partial, ax.group, dist.ReduceOp.MAX)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = all_reduce(torch.exp(partial - m_safe), ax.group)
    return torch.where(torch.isfinite(m), torch.log(s) + m_safe, m)


def _gather_labels(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """(..., N/P) label blocks -> (..., N), in rank order."""
    blocks = x.movedim(-1, 0).contiguous()
    out = blocks.new_empty((ax.size * blocks.shape[0],) + blocks.shape[1:])
    dist.all_gather_into_tensor(out, blocks, group=ax.group)
    return out.movedim(0, -1)


def _gather_transition_entries(trans_rows, rows, cols, ax: Axis):
    """T[rows, cols] from a row-split transition; replicated result (an
    indexed gather of B * S entries, once a call)."""
    n_local = trans_rows.shape[0]
    local_rows = rows - ax.index * n_local
    ok = (local_rows >= 0) & (local_rows < n_local)
    vals = trans_rows[local_rows.clamp(0, n_local - 1), cols]
    return all_reduce(torch.where(ok, vals, torch.zeros_like(vals)), ax.group)


# ---------------------------------------------------------------------------
# FCC, vocabulary-split
# ---------------------------------------------------------------------------


def _exp_rows_mat(trans_rows, dtype):
    """exp(T_rows - c) with a per-rank finite c (repaid by ``_lse_rows``)."""
    c = trans_rows.max()
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c)).to(dtype)
    return torch.exp(trans_rows.to(dtype) - c), c


def _lse_rows(x, e_mat, c):
    """lse over the contracted axis of a max-normalised exp product.

    x: (B, K); e_mat: (K, M) = exp(rows - c).  Returns (B, M) with a
    working set of O(B (K + M) + K M), never (B, K, M)."""
    m = torch.amax(x, dim=1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m_safe) @ e_mat) + m_safe + c


def _alpha_scan_vp(trans_rows, inputs_m, ax: Axis):
    """alpha blocks (T, B, N/P); an all-gather of the alpha carry a step."""
    e_rows, c = _exp_rows_mat(trans_rows, inputs_m.dtype)
    e_rows_t = e_rows.T  # (N, N/P): contract the gathered source labels
    a = inputs_m[0]
    rows = [a]
    for t in range(1, inputs_m.shape[0]):
        a = inputs_m[t] + _lse_rows(_gather_labels(a, ax), e_rows_t, c)
        rows.append(a)
    return torch.stack(rows)


def _beta_scan_vp(trans_rows, inputs_m, input_lengths, ax: Axis):
    """beta blocks (T, B, N/P); the ranks' partial lse combined a step."""
    t_total, num_batches, n_local = inputs_m.shape
    e_rows, c = _exp_rows_mat(trans_rows, inputs_m.dtype)
    zeros = torch.zeros((num_batches, n_local), dtype=inputs_m.dtype, device=inputs_m.device)
    b_next = torch.where((input_lengths == t_total)[:, None], zeros, NEG_INF)
    rows = [b_next]
    for t in range(t_total - 2, -1, -1):
        # partial over the local source labels j, for ALL destinations i
        part = _lse_rows(inputs_m[t + 1] + b_next, e_rows, c)  # (B, N)
        raw = _lse_over_ranks(part, ax).narrow(1, ax.index * n_local, n_local)
        b_next = torch.where((input_lengths - 1 == t)[:, None], zeros, raw)
        rows.append(b_next)
    return torch.stack(rows[::-1])


def _fcc_score_vp(beta, inputs_m, ax: Axis):
    return _lse_over_ranks(logsumexp(beta[0] + inputs_m[0], dim=1), ax)  # (B,)


# Time-chunk size for the backward's alpha gather + contract: bounds the
# gathered working set to (chunk, B, N) instead of the whole (T-1, B, N).
_DT_CHUNK_T = 32


def _fcc_bwd_vp(trans_rows, inputs_m, alpha, beta, score, g, ax: Axis):
    # posteriors from sum_i exp(gamma) = exp(score).  score = -inf (no valid
    # path) means every gamma is -inf too: a zero offset keeps exp(-inf) = 0
    # in place of the -inf - -inf = NaN that would poison the shared dT
    score_safe = torch.where(torch.isfinite(score), score, torch.zeros_like(score))
    grad_inputs = torch.exp(alpha + beta - score_safe[None, :, None]) * g[None, :, None]

    # dT_rows[i,j] = e_rows[i,j] * sum_{t,b} U[t,b,i] V[t,b,j] with
    # V = exp(a_prev - m), U = gI * exp(I - a_cur + m + c) (ops/fcc.py's
    # factor form, per row block); m is the all-reduced MAX of the local
    # maxima, so it needs no gather
    e_rows, c = _exp_rows_mat(trans_rows, inputs_m.dtype)
    n_local, num_labels = trans_rows.shape
    m = all_reduce(torch.amax(alpha[:-1], dim=2, keepdim=True), ax.group, dist.ReduceOp.MAX)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    sub = torch.where(torch.isfinite(alpha[1:]), inputs_m[1:] - alpha[1:], NEG_INF)
    # clamped as in ops/fcc.py::_fcc_mm_bwd: the exponent is bounded by the
    # transition's spread, not by 0
    u = grad_inputs[1:] * torch.exp(torch.clamp(sub + m_safe + c, max=60.0))
    acc = torch.zeros((n_local, num_labels), dtype=u.dtype, device=u.device)
    for t0 in range(0, u.shape[0], _DT_CHUNK_T):
        t1 = min(t0 + _DT_CHUNK_T, u.shape[0])
        v = torch.exp(_gather_labels(alpha[t0:t1], ax) - m_safe[t0:t1])  # (kt, B, N)
        acc = acc + u[t0:t1].reshape(-1, n_local).T @ v.reshape(-1, num_labels)
    return (acc * e_rows).to(trans_rows.dtype), grad_inputs


# ---------------------------------------------------------------------------
# FAC, vocabulary-split (lattice replicated; gathers and scatters split)
# ---------------------------------------------------------------------------


def _owned(tgt, n_local, ax: Axis):
    """(local label index clipped into the block, owned mask), (B, S)."""
    local = tgt - ax.index * n_local
    return local.clamp(0, n_local - 1), (local >= 0) & (local < n_local)


def _fac_gather_vp(trans_rows, inputs_shard, targets, input_lengths, target_lengths,
                   ax: Axis) -> AlignedLattice:
    t_total, num_batches, n_local = inputs_shard.shape
    s_total = targets.shape[1]
    num_labels = trans_rows.shape[1]
    tgt = targets.long().clamp(0, num_labels - 1)

    # aligned emissions from the label blocks: the owner gathers, the others
    # give exact zeros, and one all-reduce SUM assembles them.  -inf
    # emissions travel as a sentinel that the sum leaves unchanged, as in
    # ops/fac.py::gather_aligned_emissions
    idx, own = _owned(tgt, n_local, ax)
    sentinel = -1e30
    safe = torch.where(torch.isfinite(inputs_shard), inputs_shard, sentinel)
    picked = torch.gather(safe, 2, idx[None].expand(t_total, -1, -1))
    aligned = all_reduce(torch.where(own[None], picked, torch.zeros_like(picked)), ax.group)
    tmask = time_mask(t_total, input_lengths)
    smask = label_mask(s_total, target_lengths)
    valid = tmask[:, :, None] & smask[None] & (aligned > 0.5 * sentinel)
    aligned = aligned.masked_fill(~valid, NEG_INF)

    zero = torch.zeros((), dtype=trans_rows.dtype, device=trans_rows.device)
    self_trans = torch.where(smask, _gather_transition_entries(trans_rows, tgt, tgt, ax), zero)
    next_pairs = _gather_transition_entries(trans_rows, tgt[:, 1:], tgt[:, :-1], ax)
    next_trans = torch.cat([next_pairs, zero.expand(num_batches, 1)], dim=1)
    next_trans = torch.where(label_mask(s_total, target_lengths - 1), next_trans, zero)
    return AlignedLattice(aligned, self_trans, next_trans, tgt)


def _fac_grads_vp(lat: AlignedLattice, g_aligned, g_self, g_next, n_local, num_labels,
                  ax: Axis):
    """(dT rows, dI block) of the numerator: each rank writes its own rows
    and labels, without atomics (the port's ``scatter_to_full`` rules)."""
    t_total, num_batches, s_total = g_aligned.shape
    idx, own = _owned(lat.targets, n_local, ax)
    grad_inputs = g_aligned.new_zeros((t_total, num_batches, n_local))
    rows = torch.arange(num_batches, device=idx.device)
    # within one slot the B labels fall in distinct rows b: no two writes meet
    zero = torch.zeros((), dtype=g_aligned.dtype, device=g_aligned.device)
    for s in range(s_total):
        grad_inputs[:, rows, idx[:, s]] += torch.where(own[:, s], g_aligned[:, :, s], zero)
    labels, compact = torch.unique(lat.targets, sorted=True, return_inverse=True)
    small = _pair_sums(F.one_hot(compact, labels.numel()).to(g_aligned.dtype),
                       g_self, g_next)  # (U, U) over the labels in targets
    local_rows = labels - ax.index * n_local
    mine = (local_rows >= 0) & (local_rows < n_local)
    grad_rows = g_aligned.new_zeros((n_local, num_labels))
    grad_rows[local_rows[mine][:, None], labels[None, :]] = small[mine]
    return grad_rows, grad_inputs


# ---------------------------------------------------------------------------
# the criterion
# ---------------------------------------------------------------------------


class _AsgVP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, trans_rows, inputs_shard, targets, input_lengths, target_lengths,
                ax, precision):
        with strict_chain_precision(precision), ieee_fp32_products():
            inputs_m = mask_emissions(inputs_shard, input_lengths)
            beta = _beta_scan_vp(trans_rows, inputs_m, input_lengths, ax)
            full = _fcc_score_vp(beta, inputs_m, ax)
            lat = _fac_gather_vp(trans_rows, inputs_shard, targets, input_lengths,
                                 target_lengths, ax)
            beta_a = _fac_beta_scan(lat, input_lengths, target_lengths)
            aligned = _fac_score_readout(beta_a[0], lat.inputs[0])
            if any(ctx.needs_input_grad[:2]):
                alpha = _alpha_scan_vp(trans_rows, inputs_m, ax)
                ctx.save_for_backward(trans_rows, inputs_m, alpha, beta, full, *lat,
                                      _fac_alpha_scan(lat), beta_a)
        ctx.ax, ctx.precision = ax, precision
        return full - aligned

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        trans_rows, inputs_m, alpha, beta, full, *fields, alpha_a, beta_a = ctx.saved_tensors
        lat = AlignedLattice(*fields)
        n_local, num_labels = trans_rows.shape
        with strict_chain_precision(ctx.precision), ieee_fp32_products():
            # denominator part (+g)
            gt_rows, gi = _fcc_bwd_vp(trans_rows, inputs_m, alpha, beta, full, g, ctx.ax)
            # numerator part (-g): the replicated aligned-domain formula of
            # the single-process path, verbatim
            grads = aligned_domain_grads(lat, alpha_a, beta_a, -g)
            ft, fi = _fac_grads_vp(lat, *grads, n_local, num_labels, ctx.ax)
        return gt_rows + ft.to(gt_rows.dtype), gi + fi, None, None, None, None, None


def _label_check(trans_rows, inputs_shard, ax: Axis, axis: str) -> None:
    num_labels = trans_rows.shape[1]
    if num_labels % ax.size != 0:
        raise ValueError(
            f"num_labels {num_labels} not divisible by mesh axis {axis!r} = {ax.size}"
        )
    n_local = num_labels // ax.size
    if trans_rows.shape[0] != n_local or inputs_shard.shape[2] != n_local:
        raise ValueError(
            f"expected the rank's {n_local} transition rows and emission labels of "
            f"{num_labels} over mesh axis {axis!r} = {ax.size}; got "
            f"{tuple(trans_rows.shape)} and {tuple(inputs_shard.shape)}")


def asg_loss_vp(
    mesh: DeviceMesh,
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    *,
    axis: str = "model",
    reduction: str = "mean",
    precision: Optional[str] = None,
) -> torch.Tensor:
    """ASG loss with the vocabulary split over ``mesh[axis]``.

    This rank passes its block of transition rows (N/P, N) and of emission
    labels (T, B, N/P), and the whole targets and lengths; the per-element
    results are the same on every rank.  ``precision`` mirrors ``asg_loss``:
    captured here and held for the backward.
    """
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}; expected one of {REDUCTIONS}")
    precision = chain_precision() if precision is None else precision
    ax = mesh_axis(mesh, axis)
    _label_check(transition, inputs, ax, axis)
    inputs, targets, input_lengths, target_lengths = _prep(
        inputs, targets, input_lengths, target_lengths
    )
    dt = torch.promote_types(inputs.dtype, transition.dtype)
    transition = transition.to(device=inputs.device, dtype=dt)
    per_batch = _AsgVP.apply(transition, inputs.to(dt), targets, input_lengths,
                             target_lengths, ax, precision)
    return _reduce(per_batch, reduction)


def fcc_score_vp(
    mesh: DeviceMesh,
    transition: torch.Tensor,
    inputs: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    axis: str = "model",
) -> torch.Tensor:
    """Vocabulary-split denominator scores (forward only, no gradient),
    shape (B,); blocks as in ``asg_loss_vp``."""
    ax = mesh_axis(mesh, axis)
    _label_check(transition, inputs, ax, axis)
    if inputs.dtype in (torch.bfloat16, torch.float16):
        inputs = inputs.float()
    dt = torch.promote_types(inputs.dtype, transition.dtype)
    transition = transition.to(device=inputs.device, dtype=dt)
    inputs = inputs.to(dt)
    if input_lengths is None:
        input_lengths = default_lengths(inputs.shape[1], inputs.shape[0], inputs.device)
    with torch.no_grad(), ieee_fp32_products():
        inputs_m = mask_emissions(inputs, input_lengths.to(inputs.device))
        beta = _beta_scan_vp(transition, inputs_m, input_lengths.to(inputs.device), ax)
        return _fcc_score_vp(beta, inputs_m, ax)
