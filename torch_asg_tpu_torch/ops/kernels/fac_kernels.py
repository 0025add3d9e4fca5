"""The force-aligned (numerator) lattice's per-lattice kernels: the
log-domain alpha chain (K6), the beta chain (K7) and the backward (K8).

``fac_score_pallas`` is the FAC half of the per-lattice tier
(``impl='pallas'``).  The aligned lattice (``ops/fac.py::make_aligned``) is
(B, S) wide with two in-edges a state, so a step is two shifted adds and an
elementwise logaddexp:
    alpha[t, s] = A[t, s] + logaddexp(alpha[t-1, s] + self[s],
                                      alpha[t-1, s-1] + next[s-1])
from alpha[0] = A[0] on slot 0 only, and
    beta[t, s] = logaddexp(self[s] + x[s], next[s] + x[s+1]),
    x = A[t+1] + beta[t+1],
re-seeded per element at t = L_in - 1 with 0 at s = L_out - 1.  The gathered
emissions A are -inf outside ``t < L_in`` and ``s < L_out``, so K6 needs no
lengths.  The score is beta[0, 0] + A[0, 0].

A call that autograd will not differentiate runs K7 alone.  Otherwise
``_FacPallas`` runs K6 and K7 forward, and K8 backward: the aligned
posteriors softmax(alpha + beta) * g and the self and diagonal edge
fractions (exponents <= 0) summed over t >= 1 into gself and gnext (shifted
left by one slot, 0 fill), which ``scatter_to_full`` maps back to (N, N)
and (T, B, N) without atomics.  K6, K7 and K8 each have two routes, picked
by ``common.width_route`` of the slot count: the warp route (up to 128
slots) and the block route (one block walking each element's frames, one
thread per slot, up to 512 slots).  K6's warp route takes the chain
``FAC_ALPHA_BLOCK`` frames at a time: bands over (element, block of
frames), one warp per element walking the checkpoint rows alone by a
(k+1)-term log-sum-exp a block, then the rows between the checkpoints
over (element, block); ``fac_alpha_blocked_plain`` is its plain version,
``fac_alpha_plain`` the block route's.  K7's warp route walks the
log-domain chain on one warp per element, the same recursion as
``fac_beta_plain``, which is the plain version of both routes; K8's is a
posterior kernel over (element, chunk of frames), then a fixed-order sums
kernel.  On CPU tensors each wrapper runs the block route's plain
version.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/fac.cu``; on CPU tensors they run the plain versions beside them.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .common import (KERNEL_DTYPES, c_function, check_route, check_tensor,
                     count_launch, post_chunk, ptr, raise_on_error, softmax_rows,
                     stream_ptr, use_kernel, wants_grad)
from .fcc_kernels import PER_LATTICE_MAX_WIDTH
from ..fac import (AlignedLattice, _alpha_scan, _shift_left_s, _shift_right_s,
                   make_aligned, scatter_to_full)
from ..semiring import NEG_INF, logaddexp, logsumexp

# K6's warp route: the frames a block of its chain takes (csrc/fac.cu's
# kAlphaBlock), chosen from 2, 4 and 8 by timing each on the card in fp32
# and fp64 (PERF.md section 6).
FAC_ALPHA_BLOCK = 4
_BAND_SPARE = 16  # csrc/fac.cu's kBandSpare


def fac_alpha_plain(lat: AlignedLattice) -> torch.Tensor:
    """Plain version of K6: alpha (T, B, S).  The scan tier's alpha loop is
    the same recursion from the same seed."""
    return _alpha_scan(lat)


def _slots_up(x: torch.Tensor, j: int) -> torch.Tensor:
    """x shifted up by ``j`` slots along the last axis: slot s holds the old
    slot s - j, -inf below slot j."""
    if j == 0:
        return x
    pad = torch.full(x.shape[:-1] + (min(j, x.shape[-1]),), NEG_INF, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :max(x.shape[-1] - j, 0)]], dim=-1)


def _fac_alpha_bands(lat: AlignedLattice, k: int):
    """K6's warp route, step 1: the bands W (blocks, B, k+1, S) and each
    block's frame count (blocks,).  Block j starts at checkpoint t0 = j k
    and spans steps = min(k, T-1-t0) frames; W[j, b, i, s] is the log-sum
    of every path from slot s-i at frame t0 to slot s at frame t0 + steps
    with exactly i advances, counting each transition and the emissions of
    frames t0+1 .. t0+steps (-inf where no such path exists).  The band
    recursion, m = 1 .. steps, from w = 0 at i = 0 and -inf elsewhere:
        w[s, i] = A_{t0+m}[s] + logaddexp(w[s, i] + self[s],
                                          w[s-1, i-1] + next[s-1])."""
    t_total, num_batches, s_total = lat.inputs.shape
    dev, dt = lat.inputs.device, lat.inputs.dtype
    nblocks = -(-(t_total - 1) // k)
    t0 = torch.arange(nblocks, device=dev) * k
    steps = (t_total - 1 - t0).clamp(max=k)
    w = torch.full((nblocks, num_batches, k + 1, s_total), NEG_INF, dtype=dt, device=dev)
    w[:, :, 0] = 0.0
    self_t = lat.self_trans[None, :, None, :]
    next_t = lat.next_trans[None, :, None, :]
    no_source = torch.full_like(w[:, :, :1], NEG_INF)
    for m in range(1, k + 1):
        a = lat.inputs[(t0 + m).clamp(max=max(t_total - 1, 0))][:, :, None, :]
        move = torch.cat([no_source, _shift_right_s(w + next_t)[:, :, :-1]], dim=2)
        w = torch.where((m <= steps)[:, None, None, None], a + logaddexp(w + self_t, move), w)
    return w, steps


def fac_alpha_blocked_plain(lat: AlignedLattice, k: int) -> torch.Tensor:
    """Plain version of K6's warp route: alpha (T, B, S), the recursion of
    ``fac_alpha_plain`` taken k frames at a time.

    1. The bands W (``_fac_alpha_bands``), parallel over (element, block).
    2. The chain over the checkpoints t0 = 0, k, 2k, ...: from alpha_0 (A_0
       at slot 0, -inf elsewhere), the row that ends block j is the
       (k+1)-term log-sum-exp
           alpha_{t0+steps}[s] = LSE_i (alpha_{t0}[s-i] + W[j, :, i, s]),
       all--inf terms giving -inf.
    3. The fill, parallel over (element, block): rows t0+1 .. t0+steps-1
       from checkpoint t0 by the one-step recursion.
    """
    t_total, num_batches, s_total = lat.inputs.shape
    alpha = torch.empty_like(lat.inputs)
    if alpha.numel() == 0:
        return alpha
    w, steps = _fac_alpha_bands(lat, k)
    a = torch.full((num_batches, s_total), NEG_INF, dtype=alpha.dtype, device=alpha.device)
    a[:, 0] = lat.inputs[0, :, 0]
    alpha[0] = a
    t0 = torch.arange(w.shape[0], device=alpha.device) * k
    for j in range(w.shape[0]):
        terms = torch.stack([_slots_up(a, i) for i in range(k + 1)], dim=1) + w[j]
        a = logsumexp(terms, dim=1)
        alpha[int(t0[j] + steps[j])] = a
    cur = alpha[t0]
    for m in range(1, k):
        cur = lat.inputs[(t0 + m).clamp(max=t_total - 1)] + logaddexp(
            cur + lat.self_trans, _shift_right_s(cur + lat.next_trans))
        keep = m < steps
        alpha[t0[keep] + m] = cur[keep]
    return alpha


def fac_beta_plain(lat: AlignedLattice, input_lengths, target_lengths):
    """Plain version of K7: beta (T, B, S), t descending over every frame,
    with the per-element seed select at t = L_in - 1."""
    t_total, num_batches, s_total = lat.inputs.shape
    dev = lat.inputs.device
    li = input_lengths.to(device=dev, dtype=torch.long)[:, None]
    lo = target_lengths.to(device=dev, dtype=torch.long)[:, None]
    s_idx = torch.arange(s_total, device=dev)[None, :]
    seed = torch.where(s_idx == lo - 1, 0.0, NEG_INF).to(lat.inputs.dtype)
    beta = torch.empty_like(lat.inputs)
    b = torch.where(li - 1 == t_total - 1, seed, NEG_INF)
    beta[t_total - 1] = b
    for t in range(t_total - 2, -1, -1):
        x = lat.inputs[t + 1] + b
        raw = logaddexp(lat.self_trans + x, lat.next_trans + _shift_left_s(x))
        b = torch.where(li - 1 == t, seed, raw)
        beta[t] = b
    return beta


def fac_bwd_plain(lat: AlignedLattice, alpha, beta, g):
    """Plain version of K8: (dA (T, B, S), gself (B, S), gnext (B, S)).

    Per frame the aligned posterior softmax(alpha + beta) * g (all--inf
    rows give zeros); for t >= 1 it weights the self-loop fraction (1 at
    slot 0) into gself and the diagonal fraction into a sum that becomes
    gnext, shifted left by one slot with 0 fill."""
    t_total, num_batches, s_total = lat.inputs.shape
    dev = lat.inputs.device
    g = g.to(lat.inputs.dtype)[:, None]
    first = torch.arange(s_total, device=dev)[None, :] == 0
    gi_all = torch.empty_like(lat.inputs)
    acc_self = torch.zeros_like(lat.self_trans)
    acc_diag = torch.zeros_like(lat.self_trans)
    for t in range(t_total):
        a_cur = alpha[t]
        gamma = a_cur + beta[t]
        m = torch.amax(gamma, dim=1, keepdim=True)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        ex = torch.exp(gamma - m_safe)
        denom = torch.sum(ex, dim=1, keepdim=True)
        gi = ex / torch.where(denom == 0.0, torch.ones_like(denom), denom) * g
        gi_all[t] = gi
        if t > 0:
            a_prev = alpha[t - 1]
            sub = torch.where(torch.isfinite(a_cur), lat.inputs[t] - a_cur, NEG_INF)
            hori = torch.exp(a_prev + lat.self_trans + sub)
            diag = torch.exp(_shift_right_s(a_prev + lat.next_trans) + sub)
            acc_self += gi * torch.where(first, 1.0, hori)
            acc_diag += gi * diag
    return gi_all, acc_self, _shift_left_s(acc_diag, fill=0.0)


def _fac_bwd_split_plain(lat: AlignedLattice, alpha, beta, g, chunk=None):
    """Plain version of K8's warp route: ``fac_bwd_plain``'s outputs with no
    walk over the frames.  Used by the tests; the main path runs
    ``fac_bwd_plain`` on CPU tensors.

    1. Per (element, chunk of ``chunk`` frames; default ``post_chunk``):
       frame t needs rows t of alpha, beta and A and row t-1 of alpha.  dA_t
       = softmax(alpha_t + beta_t) * g; the chunk's partials are the sums
       over its frames t >= 1 of dA_t times the self fraction (1 at slot 0)
       and of dA_t times the diagonal fraction.
    2. gself and gdiag are the partials summed over the chunks; gnext is
       gdiag shifted left by one slot, 0 fill.
    """
    t_total, num_batches, s_total = lat.inputs.shape
    if chunk is None:
        chunk = post_chunk(t_total, num_batches)
    dt = lat.inputs.dtype

    # ---- 1: posteriors and per-chunk partials
    gi = softmax_rows(alpha + beta) * g.to(dt)[:, None]
    a_prev, a_cur = alpha[:-1], alpha[1:]
    sub = torch.where(torch.isfinite(a_cur), lat.inputs[1:] - a_cur, NEG_INF)
    hori = torch.exp(a_prev + lat.self_trans + sub)
    hori[..., 0] = 1.0  # slot 0 has only the self-loop in-edge
    diag = torch.exp(_shift_right_s(a_prev + lat.next_trans) + sub)
    terms = (gi[1:] * hori, gi[1:] * diag)  # frames 1 .. T-1
    nchunks = -(-t_total // chunk)
    parts = torch.zeros((2, nchunks, num_batches, s_total), dtype=dt, device=alpha.device)
    for k in range(nchunks):
        lo, hi = max(k * chunk, 1), min((k + 1) * chunk, t_total)
        for q, term in enumerate(terms):
            parts[q, k] = term[lo - 1:hi - 1].sum(dim=0)

    # ---- 2: the sums
    gself, gdiag = parts.sum(dim=1)
    return gi, gself, _shift_left_s(gdiag, fill=0.0)


def _check_lattice(lat, li=None, lo=None):
    t_total, num_batches, s_total = lat.inputs.shape
    dev, dt = lat.inputs.device, lat.inputs.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"FAC kernels take float32 or float64, got {dt}")
    if s_total > PER_LATTICE_MAX_WIDTH:
        raise ValueError(f"FAC kernels take s_total <= {PER_LATTICE_MAX_WIDTH}; "
                         f"got {s_total}")
    check_tensor("aligned", lat.inputs, dt, (t_total, num_batches, s_total), dev)
    check_tensor("self_trans", lat.self_trans, dt, (num_batches, s_total), dev)
    check_tensor("next_trans", lat.next_trans, dt, (num_batches, s_total), dev)
    for name, t in (("input_lengths", li), ("target_lengths", lo)):
        if t is not None:
            check_tensor(name, t, torch.int32, (num_batches,), dev)


def _contiguous(lat: AlignedLattice) -> AlignedLattice:
    return AlignedLattice(lat.inputs.contiguous(), lat.self_trans.contiguous(),
                          lat.next_trans.contiguous(), lat.targets)


def _launch_alpha(route, lat, alpha):
    """Launch K6 on ``route`` with the output ``alpha``: ``fac_alpha_{f32,f64}``
    (the block route) or ``fac_alpha_warp_{f32,f64}`` (the bands, the chain
    over checkpoints ``FAC_ALPHA_BLOCK`` frames apart, and the fill, with a
    scratch of bands and the band and fill kernels over chunks of
    ``post_chunk`` blocks).  The bands' scratch is (blocks + _BAND_SPARE,
    B, FAC_ALPHA_BLOCK+1, 32 RS): rows padded to the warp's lane layout,
    RS = 1, 2 or 4 words a lane, and spare blocks that the chain reads past
    the last block and never uses."""
    t_total, num_batches, s_total = lat.inputs.shape
    dev, dt = lat.inputs.device, lat.inputs.dtype
    ptrs = [lat.inputs, lat.self_trans, lat.next_trans, alpha]
    sizes = [t_total, num_batches, s_total]
    if route == "warp":
        nblocks = -(-(t_total - 1) // FAC_ALPHA_BLOCK)
        lane_words = 32 * next(r for r in (1, 2, 4) if s_total <= 32 * r)
        ptrs.append(torch.empty((nblocks + _BAND_SPARE, num_batches, FAC_ALPHA_BLOCK + 1,
                                 lane_words), dtype=dt, device=dev))
        sizes.append(post_chunk(nblocks, num_batches))
    stem = "fac_alpha_warp" if route == "warp" else "fac_alpha"
    fn = c_function("fac", stem, dt, len(ptrs), len(sizes))
    with torch.cuda.device(dev):
        err = fn(*map(ptr, ptrs), *sizes, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def fac_alpha_pallas(lat: AlignedLattice, *, route=None) -> torch.Tensor:
    """alpha (T, B, S): K6 on CUDA tensors, on ``route`` ('warp', 'block',
    or None for ``width_route`` of the slot count), and its plain version
    on CPU ones.  Counts each launch in ``common.LAUNCHES`` as ``K6``
    and ``K6.<route>``."""
    route = check_route("K6", route, lat.inputs.shape[2])
    if not use_kernel(lat.inputs, lat.self_trans, lat.next_trans):
        return fac_alpha_plain(lat)
    lat = _contiguous(lat)
    _check_lattice(lat)
    alpha = torch.empty_like(lat.inputs)
    if alpha.numel() == 0:
        return alpha
    _launch_alpha(route, lat, alpha)
    count_launch("K6", route)
    return alpha


def _launch_beta(route, lat, li, lo, beta):
    """Launch K7 on ``route`` with the output ``beta``: ``fac_beta_{f32,f64}``
    (the block route) or ``fac_beta_warp_{f32,f64}`` (one warp per element);
    both take the same arguments."""
    t_total, num_batches, s_total = lat.inputs.shape
    dev = lat.inputs.device
    stem = "fac_beta_warp" if route == "warp" else "fac_beta"
    fn = c_function("fac", stem, beta.dtype, 6, 3)
    with torch.cuda.device(dev):
        err = fn(ptr(lat.inputs), ptr(lat.self_trans), ptr(lat.next_trans), ptr(li),
                 ptr(lo), ptr(beta), t_total, num_batches, s_total, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def fac_beta_pallas(lat: AlignedLattice, input_lengths, target_lengths, *, route=None):
    """beta (T, B, S): K7 on CUDA tensors, on ``route`` ('warp', 'block', or
    None for ``width_route`` of the slot count), and its plain version on
    CPU ones.  Counts each launch in ``common.LAUNCHES`` as ``K7`` and
    ``K7.<route>``."""
    route = check_route("K7", route, lat.inputs.shape[2])
    if not use_kernel(lat.inputs, lat.self_trans, lat.next_trans, input_lengths,
                      target_lengths):
        return fac_beta_plain(lat, input_lengths, target_lengths)
    lat = _contiguous(lat)
    li = input_lengths.to(torch.int32).contiguous()
    lo = target_lengths.to(torch.int32).contiguous()
    _check_lattice(lat, li, lo)
    beta = torch.empty_like(lat.inputs)
    if beta.numel() == 0:
        return beta
    _launch_beta(route, lat, li, lo, beta)
    count_launch("K7", route)
    return beta


def _launch_bwd(route, lat, alpha, beta, g, outs):
    """Launch K8 on ``route`` with the outputs ``outs`` (dA, gself, gnext):
    ``fac_bwd_{f32,f64}`` (the block route) or ``fac_bwd_warp_{f32,f64}``
    (the posterior kernel over chunks of ``post_chunk`` frames, then the
    sums, with a (2, chunks, B, S) scratch of partials between them)."""
    t_total, num_batches, s_total = lat.inputs.shape
    dev, dt = lat.inputs.device, lat.inputs.dtype
    ptrs = [lat.inputs, lat.self_trans, lat.next_trans, alpha, beta, g, *outs]
    sizes = [t_total, num_batches, s_total]
    if route == "warp":
        chunk = post_chunk(t_total, num_batches)
        nchunks = -(-t_total // chunk)
        ptrs.append(torch.empty((2, nchunks, num_batches, s_total), dtype=dt, device=dev))
        sizes.append(chunk)
    stem = "fac_bwd_warp" if route == "warp" else "fac_bwd"
    fn = c_function("fac", stem, dt, len(ptrs), len(sizes))
    with torch.cuda.device(dev):
        err = fn(*map(ptr, ptrs), *sizes, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def fac_bwd_pallas(lat: AlignedLattice, alpha, beta, g, *, route=None):
    """(dA (T, B, S), gself (B, S), gnext (B, S)): K8 on CUDA tensors, on
    ``route`` ('warp', 'block', or None for ``width_route`` of the slot
    count), and its plain version on CPU ones.  Both routes sum the edge
    terms in a fixed order, so two runs give the same bits.
    Counts each launch in ``common.LAUNCHES`` as ``K8`` and
    ``K8.<route>``."""
    route = check_route("K8", route, lat.inputs.shape[2])
    if not use_kernel(lat.inputs, lat.self_trans, lat.next_trans, alpha, beta, g):
        return fac_bwd_plain(lat, alpha, beta, g)
    lat = _contiguous(lat)
    _check_lattice(lat)
    num_batches = lat.inputs.shape[1]
    dev, dt = lat.inputs.device, lat.inputs.dtype
    g = g.to(dt).contiguous()
    check_tensor("alpha", alpha, dt, lat.inputs.shape, dev)
    check_tensor("beta", beta, dt, lat.inputs.shape, dev)
    check_tensor("g", g, dt, (num_batches,), dev)
    gi = torch.empty_like(lat.inputs)
    gself = torch.empty_like(lat.self_trans)
    gnext = torch.empty_like(lat.self_trans)
    if gi.numel() == 0:
        return gi, gself.zero_(), gnext.zero_()
    _launch_bwd(route, lat, alpha, beta, g, (gi, gself, gnext))
    count_launch("K8", route)
    return gi, gself, gnext


def _score(beta0, aligned0):
    # every aligned path starts at (t = 0, s = 0)
    return beta0[:, 0] + aligned0[:, 0]


class _FacPallas(torch.autograd.Function):
    """K6 and K7 forward, K8 + ``scatter_to_full`` backward."""

    @staticmethod
    def forward(ctx, transition, inputs, targets, input_lengths, target_lengths):
        lat = make_aligned(transition, inputs, targets, input_lengths, target_lengths)
        alpha = fac_alpha_pallas(lat)
        beta = fac_beta_pallas(lat, input_lengths, target_lengths)
        ctx.save_for_backward(*lat, alpha, beta)
        ctx.num_labels = inputs.shape[2]
        return _score(beta[0], lat.inputs[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        *fields, alpha, beta = ctx.saved_tensors
        lat = AlignedLattice(*fields)
        grads = fac_bwd_pallas(lat, alpha, beta, g)
        grad_transition, grad_inputs = scatter_to_full(lat, *grads, ctx.num_labels)
        return grad_transition, grad_inputs, None, None, None


def fac_score_pallas(transition: torch.Tensor, inputs: torch.Tensor,
                     targets: torch.Tensor, input_lengths: torch.Tensor,
                     target_lengths: torch.Tensor) -> torch.Tensor:
    """Per-lattice numerator scores, shape (B,); same contract as
    ``ops.fac.fac_score``.  A call that autograd will not differentiate runs
    K7 alone; otherwise K6 and K7 forward and K8 backward."""
    transition = transition.to(inputs.dtype)
    if wants_grad(transition, inputs):
        return _FacPallas.apply(transition, inputs, targets, input_lengths,
                                target_lengths)
    lat = make_aligned(transition, inputs, targets, input_lengths, target_lengths)
    beta = fac_beta_pallas(lat, input_lengths, target_lengths)
    return _score(beta[0], lat.inputs[0])

