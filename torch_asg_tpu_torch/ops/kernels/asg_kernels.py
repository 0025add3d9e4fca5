"""Fused ASG scores and gradients: both beta chains in one kernel (K1), both
alpha chains and every gradient in another (K2).

``asg_scores_fused`` gathers the aligned lattice (``ops/fac.py``), builds the
exp-domain transition ``E = exp(T - c)``, runs both beta chains with t
descending, and repays the FCC chain's per-step ``exp(-c)`` scaling as
``(L_in - 1) * c``.  When autograd will not ask for a gradient it runs the
score-only kernel (K1, no stores).  Otherwise it runs ``_FusedScores``, a
``torch.autograd.Function``: its forward runs K1 with stores, which also
writes the beta residuals PB (FCC, exp domain, each row rescaled to max 1)
and QB (FAC, log domain); its backward runs K2, which walks t ascending,
recomputes both alpha chains, and emits the emission, aligned-emission,
transition and edge gradients in one pass, and then ``scatter_to_full``
maps the aligned-domain gradients back.  ``c`` is held fixed: the gradient
is the exact one, since ``c`` cancels against its repayment.

On CUDA tensors the chains run in the hand-written kernels
``csrc/asg_fwd.cu`` (K1, both variants) and ``csrc/asg_bwd.cu`` (K2); on CPU
tensors in ``_fwd_scores_plain``, ``_fwd_store_plain`` and ``_bwd_plain``,
step-by-step loops of the same arithmetic.  K1 and K2 each have two routes
with the same outputs, chosen by ``common.width_route``: up to
``common.WARP_MAX_WIDTH`` labels and target slots one warp walks each chain
of an element, past it one block of one thread per label and slot walks
both.
K2's warp route keeps only the chains on those warps: a second kernel
computes the posteriors and the transition product over chunks of frames
in parallel, and a third sums the partials (``_bwd_split_plain`` is its
algorithm in torch).

Numeric domains: the FCC chains run in the exp domain with a per-step
rescale to max 1 and the log-maxes summed into an offset (full connectivity
bounds a row's spread by one step's emission + transition spread, which the
60-nat guard in ``asg.py`` keeps inside the fp32 exp range).  The FAC chains
stay in the log domain, because an aligned row's spread grows with
``|s - t*S/T|``.  The gradients use only log-space softmaxes and exps of
exponents <= 0.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .common import (KERNEL_DTYPES, c_function, check_route, check_tensor,
                     count_launch, exp_rows, post_chunk, ptr, raise_on_error,
                     softmax_rows, stream_ptr, use_kernel, wants_grad)
from ..fac import (AlignedLattice, _shift_left_s, _shift_right_s, make_aligned,
                   scatter_to_full)
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


def _beta_walk(e, self_trans, next_trans, inputs, aligned, input_lengths,
               target_lengths, store):
    """Both beta chains, t from T-1 down to 0, for the whole batch at once:
    (sful, sfac), each (B,), before the ``(L_in - 1) * c`` repayment, led by
    the residuals PB (T, B, N) and QB (T, B, S) when ``store``.

    Each element re-seeds at its own ``t = L_in - 1`` (FCC beta = 1 on every
    label, FAC beta = 0 at ``s = L_out - 1``), which discards whatever the
    chains held at later frames.  An element with L_in outside [1, T] is
    never seeded and has no path: both scores are -inf, as in the kernel.
    Residual rows at ``t >= L_in`` hold the semiring zeros (PB = 0,
    QB = -inf), as the kernel's wrapper allocates them.
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
    bad = (li < 1) | (li > t_total)
    if store:
        pb_all = torch.zeros((t_total, num_batches, num_labels), dtype=dt, device=dev)
        qb_all = torch.full((t_total, num_batches, s_total), NEG_INF, dtype=dt,
                            device=dev)

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
        if store:
            live = ((t < li) & ~bad)[:, None]
            pb_all[t] = torch.where(live, pb, 0.0)
            qb_all[t] = torch.where(live, qb, NEG_INF)
        row = inputs[t].masked_fill((t >= li)[:, None], NEG_INF)
        ex_n, m_n = exp_rows(row)
        ai_n = aligned[t]
    sful = torch.log(torch.sum(pb * ex_n, dim=1)) + m_n + off
    sfac = qb[:, 0] + ai_n[:, 0]
    scores = sful.masked_fill(bad, NEG_INF), sfac.masked_fill(bad, NEG_INF)
    return (pb_all, qb_all, *scores) if store else scores


def _fwd_scores_plain(e, self_trans, next_trans, inputs, aligned,
                      input_lengths, target_lengths):
    """Plain version of K1 without stores: (sful, sfac)."""
    return _beta_walk(e, self_trans, next_trans, inputs, aligned,
                      input_lengths, target_lengths, store=False)


def _fwd_store_plain(e, self_trans, next_trans, inputs, aligned,
                     input_lengths, target_lengths):
    """Plain version of K1 with stores: (PB, QB, sful, sfac)."""
    return _beta_walk(e, self_trans, next_trans, inputs, aligned,
                      input_lengths, target_lengths, store=True)


def _bwd_plain(e, self_trans, next_trans, inputs, aligned, input_lengths,
               pb, qb, g_full, g_fac):
    """Plain version of K2: (gI (T, B, N), gA (T, B, S), dT (N, N),
    gself (B, S), gnext (B, S)).

    Walks t from 0 up, for the whole batch at once, recomputing both alpha
    chains from their t = 0 seeds (FCC: the emission row; FAC: slot 0 only):
      s = pa_{t-1} @ E^T (s = 1 at t = 0),  lpa = log s + I_t,
      pa_t = exp(lpa - max lpa)                  (the rescaled FCC alpha)
      gI_t = softmax(lpa + log PB_t) * g_full    (log space: pa * pb may
                                                  underflow in fp32)
      acc += (gI_t / s) outer pa_{t-1}           (the transition posteriors)
      qa_t = A_t + logaddexp(qa_{t-1} + self, shift_right(qa_{t-1} + next))
      gA_t = softmax(qa_t + QB_t) * g_fac
    and the FAC edge fractions, exps of exponents <= 0, weight gA_t into
    gself and gnext for t >= 1.  After the walk dT = (sum_b acc_b) * E and
    gnext is the diagonal mass shifted left by one slot.  Frames with
    t >= L_in, and every frame of an element with L_in outside [1, T],
    contribute nothing.
    """
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    li = input_lengths.to(device=dev, dtype=torch.long)
    bad = (li < 1) | (li > t_total)
    e_t = e.T
    s_idx = torch.arange(s_total, device=dev)
    g_full = g_full.to(dt)[:, None]
    g_fac = g_fac.to(dt)[:, None]
    gi_all = torch.zeros((t_total, num_batches, num_labels), dtype=dt, device=dev)
    ga_all = torch.zeros((t_total, num_batches, s_total), dtype=dt, device=dev)
    acc = torch.zeros((num_batches, num_labels, num_labels), dtype=dt, device=dev)
    acc_self = torch.zeros((num_batches, s_total), dtype=dt, device=dev)
    acc_diag = torch.zeros_like(acc_self)
    pa = torch.zeros((num_batches, num_labels), dtype=dt, device=dev)
    qa = torch.full((num_batches, s_total), NEG_INF, dtype=dt, device=dev)
    for t in range(t_total):
        dead = ~((t < li) & ~bad)[:, None]
        row = inputs[t].masked_fill(dead, NEG_INF)
        av = aligned[t].masked_fill(dead, NEG_INF)
        # ---- FCC alpha (exp domain) and the emission posteriors
        s = torch.ones_like(pa) if t == 0 else pa @ e_t
        lpa = torch.log(s) + row
        m_a = torch.amax(lpa, dim=1, keepdim=True)
        m_a = torch.where(torch.isfinite(m_a), m_a, torch.zeros_like(m_a))
        pa_prev, pa = pa, torch.exp(lpa - m_a)
        gi = softmax_rows(lpa + torch.log(pb[t])) * g_full
        gi_all[t] = gi
        if t > 0:
            u = gi / torch.where(s > 0, s, torch.ones_like(s))
            acc += u[:, :, None] * pa_prev[:, None, :]
        # ---- FAC alpha (log domain) and the aligned posteriors
        if t == 0:
            qa_new = av.masked_fill(s_idx[None, :] != 0, NEG_INF)
        else:
            y = _shift_right_s(qa + next_trans)
            qa_new = av + logaddexp(qa + self_trans, y)
        gq = softmax_rows(qa_new + qb[t]) * g_fac
        ga_all[t] = gq
        if t > 0:
            sub = torch.where(torch.isfinite(qa_new), av - qa_new, NEG_INF)
            hori = torch.exp(qa + self_trans + sub)
            # slot 0 has only the self-loop in-edge, fraction 1
            acc_self += gq * torch.where(s_idx[None, :] == 0, 1.0, hori)
            acc_diag += gq * torch.exp(y + sub)
        qa = qa_new
    d_trans = acc.sum(dim=0) * e
    return gi_all, ga_all, d_trans, acc_self, _shift_left_s(acc_diag, fill=0.0)


def _alpha_rows(e, self_trans, next_trans, inputs, aligned):
    """Phase 1 of K2's warp route, both alpha chains for every element and
    frame: (S (T, B, N), QA (T, B, S)).

    FCC, exp domain: s_t = pa_{t-1} @ E^T (s_0 = 1) and
    pa_t = rescale(s_t * exp(I_t - max I_t)) to max 1, the block route's
    exp(log s_t + I_t - max) without a log on the chain; S holds the raw
    rows s_t.  FAC, log domain: qa_t = A_t + logaddexp(qa_{t-1} + self,
    shift_right(qa_{t-1} + next)), seeded on slot 0 at t = 0.  Rows at
    t >= L_in are computed but never read.
    """
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    e_t = e.T
    s_rows = torch.empty((t_total, num_batches, num_labels), dtype=dt, device=dev)
    qa_rows = torch.empty((t_total, num_batches, s_total), dtype=dt, device=dev)
    s_idx = torch.arange(s_total, device=dev)
    pa = qa = None
    for t in range(t_total):
        s = torch.ones((num_batches, num_labels), dtype=dt, device=dev) if t == 0 else pa @ e_t
        x = s * exp_rows(inputs[t])[0]
        m = torch.amax(x, dim=1, keepdim=True)
        pa = x * (1.0 / torch.where(m > 0, m, torch.ones_like(m)))
        s_rows[t] = s
        if t == 0:
            qa = aligned[0].masked_fill(s_idx[None, :] != 0, NEG_INF)
        else:
            qa = aligned[t] + logaddexp(qa + self_trans, _shift_right_s(qa + next_trans))
        qa_rows[t] = qa
    return s_rows, qa_rows


def _bwd_split_plain(e, self_trans, next_trans, inputs, aligned, input_lengths,
                     pb, qb, g_full, g_fac, chunk=None):
    """Plain version of K2's warp route: ``_bwd_plain``'s outputs, computed
    in the route's three phases.  Used by the tests; the main path runs
    ``_bwd_plain`` on CPU tensors.

    1. ``_alpha_rows``: the two chains, keeping only their rows S and QA.
    2. Posteriors, with no recurrence, per (element, chunk of ``chunk``
       frames; default ``post_chunk``): every quantity of frame t comes
       from rows t and t-1 of S, I, PB, QA, A, QB.  lpa_t = log s_t + I_t,
       gI_t = softmax(lpa_t + log PB_t) * g_full, gA_t = softmax(qa_t +
       QB_t) * g_fac; the chunk's (N, N) partial sum over t >= 1 of
       (gI_t / s_t) outer pa_{t-1}, pa_{t-1} = exp(lpa_{t-1} - max); and the
       chunk's gself and diagonal partials from the FAC edge fractions.
    3. The sums of the partials: dT = (sum of the partials) * E, gself, and
       gnext, the diagonal mass shifted left one slot.
    Frames t >= L_in, and every frame of an element with L_in outside
    [1, T], contribute nothing.
    """
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    if chunk is None:
        chunk = post_chunk(t_total, num_batches)
    li = input_lengths.to(device=dev, dtype=torch.long)
    bad = (li < 1) | (li > t_total)
    live = (torch.arange(t_total, device=dev)[:, None] < li[None, :]) & ~bad[None, :]
    live = live[..., None]  # (T, B, 1)
    s_rows, qa_rows = _alpha_rows(e, self_trans, next_trans, inputs, aligned)

    # ---- phase 2: posteriors and per-chunk partials
    lpa = torch.log(s_rows) + inputs
    gi = torch.where(live, softmax_rows(lpa + torch.log(pb)) * g_full.to(dt)[:, None], 0.0)
    m_a = torch.amax(lpa, dim=2, keepdim=True)
    pa = torch.where(live, torch.exp(lpa - torch.where(torch.isfinite(m_a), m_a, 0.0)), 0.0)
    u = gi / torch.where(s_rows > 0, s_rows, torch.ones_like(s_rows))
    ga = torch.where(live, softmax_rows(qa_rows + qb) * g_fac.to(dt)[:, None], 0.0)
    qa, qa_prev = qa_rows[1:], qa_rows[:-1]
    sub = torch.where(torch.isfinite(qa), aligned[1:] - qa, NEG_INF)
    hori = torch.exp(qa_prev + self_trans + sub)
    hori[..., 0] = 1.0  # slot 0 has only the self-loop in-edge, fraction 1
    diag = torch.exp(_shift_right_s(qa_prev + next_trans) + sub)
    edge_self = torch.where(live[1:], ga[1:] * hori, 0.0)  # frames 1 .. T-1
    edge_diag = torch.where(live[1:], ga[1:] * diag, 0.0)
    nchunks = -(-t_total // chunk)
    part = torch.zeros((num_batches, nchunks, num_labels, num_labels), dtype=dt, device=dev)
    pself = torch.zeros((num_batches, nchunks, s_total), dtype=dt, device=dev)
    pdiag = torch.zeros_like(pself)
    for c in range(nchunks):
        lo, hi = max(c * chunk, 1), min((c + 1) * chunk, t_total)
        part[:, c] = torch.einsum("tbi,tbj->bij", u[lo:hi], pa[lo - 1:hi - 1])
        pself[:, c] = edge_self[lo - 1:hi - 1].sum(dim=0)
        pdiag[:, c] = edge_diag[lo - 1:hi - 1].sum(dim=0)

    # ---- phase 3: the sums
    d_trans = part.sum(dim=(0, 1)) * e
    return gi, ga, d_trans, pself.sum(dim=1), _shift_left_s(pdiag.sum(dim=1), fill=0.0)


def _lattice_args(e, self_trans, next_trans, inputs, aligned, input_lengths,
                  target_lengths=None):
    """Check what K1 and K2 take; returns the lengths as contiguous int32."""
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"ASG kernels take float32 or float64, got {dt}")
    if max(num_labels, s_total) > KERNEL_MAX_WIDTH:
        raise ValueError(
            f"ASG kernels take max(num_labels, s_total) <= {KERNEL_MAX_WIDTH}; "
            f"got num_labels={num_labels}, s_total={s_total}")
    for name, t, shape in (
        ("e", e, (num_labels, num_labels)),
        ("self_trans", self_trans, (num_batches, s_total)),
        ("next_trans", next_trans, (num_batches, s_total)),
        ("inputs", inputs, (t_total, num_batches, num_labels)),
        ("aligned", aligned, (t_total, num_batches, s_total)),
    ):
        check_tensor(name, t, dt, shape, dev)
    lengths = []
    for name, t in (("input_lengths", input_lengths), ("target_lengths", target_lengths)):
        if t is not None:
            t = t.to(device=dev, dtype=torch.int32).contiguous()
            check_tensor(name, t, torch.int32, (num_batches,), dev)
            lengths.append(t)
    return lengths


def _launch_fwd(variant, route, e, self_trans, next_trans, inputs, aligned,
                li, lo, outs):
    """Launch K1's ``variant`` ('scores' or 'store') on ``route`` with the
    output pointers ``outs``: ``asg_fwd_{variant}_{f32,f64}`` (the block
    route) or ``asg_fwd_warp_{variant}_{f32,f64}``."""
    t_total, num_batches, num_labels = inputs.shape
    dev = inputs.device
    stem = f"asg_fwd_warp_{variant}" if route == "warp" else f"asg_fwd_{variant}"
    fn = c_function("asg_fwd", stem, inputs.dtype, 7 + len(outs), 4)
    with torch.cuda.device(dev):
        err = fn(ptr(inputs), ptr(aligned), ptr(e), ptr(self_trans),
                 ptr(next_trans), ptr(li), ptr(lo), *map(ptr, outs), t_total,
                 num_batches, num_labels, aligned.shape[2], stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def _fwd_scores_kernel(e, self_trans, next_trans, inputs, aligned,
                       input_lengths, target_lengths, *, route=None):
    """Launch K1 without stores (csrc/asg_fwd.cu) on ``route`` ('warp',
    'block', or None for ``width_route``).  Counts each launch in
    ``common.LAUNCHES`` as ``K1`` and ``K1.<route>``."""
    num_batches, num_labels = inputs.shape[1:]
    route = check_route("K1", route, max(num_labels, aligned.shape[2]))
    dev, dt = inputs.device, inputs.dtype
    li, lo = _lattice_args(e, self_trans, next_trans, inputs, aligned,
                           input_lengths, target_lengths)
    sful = torch.empty((num_batches,), dtype=dt, device=dev)
    sfac = torch.empty((num_batches,), dtype=dt, device=dev)
    if num_batches == 0:
        return sful, sfac
    _launch_fwd("scores", route, e, self_trans, next_trans, inputs, aligned, li, lo,
                (sful, sfac))
    count_launch("K1", route)
    return sful, sfac


def _fwd_store_kernel(e, self_trans, next_trans, inputs, aligned,
                      input_lengths, target_lengths, *, route=None):
    """Launch K1 with stores (csrc/asg_fwd.cu) on ``route``, as
    ``_fwd_scores_kernel`` does.  Returns (PB, QB, sful, sfac); the kernel
    writes residual rows t < L_in[b] and this wrapper fills the rest with
    the semiring zeros.  Counts each launch in ``common.LAUNCHES`` as
    ``K1s`` and ``K1s.<route>``."""
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    route = check_route("K1", route, max(num_labels, s_total))
    dev, dt = inputs.device, inputs.dtype
    li, lo = _lattice_args(e, self_trans, next_trans, inputs, aligned,
                           input_lengths, target_lengths)
    pb = torch.zeros((t_total, num_batches, num_labels), dtype=dt, device=dev)
    qb = torch.full((t_total, num_batches, s_total), NEG_INF, dtype=dt, device=dev)
    sful = torch.empty((num_batches,), dtype=dt, device=dev)
    sfac = torch.empty((num_batches,), dtype=dt, device=dev)
    if num_batches == 0:
        return pb, qb, sful, sfac
    _launch_fwd("store", route, e, self_trans, next_trans, inputs, aligned, li, lo,
                (pb, qb, sful, sfac))
    count_launch("K1s", route)
    return pb, qb, sful, sfac


def _launch_bwd(route, e, self_trans, next_trans, inputs, aligned, li, pb, qb,
                g_full, g_fac, outs):
    """Launch K2 on ``route`` with the output pointers ``outs`` (gI, gA, dT,
    gself, gnext) and the route's scratch: ``asg_bwd_{f32,f64}`` (the block
    route; per-element (N, N) partials) or ``asg_bwd_warp_{f32,f64}`` (the
    chain rows S and QA, and per-(element, chunk) partials)."""
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    gi, ga, d_trans, gself, gnext = outs
    sizes = [t_total, num_batches, num_labels, s_total]
    ptrs = [inputs, aligned, e, e.T.contiguous(), self_trans, next_trans, li, pb, qb,
            g_full, g_fac, gi, ga]
    if route == "warp":
        chunk = post_chunk(t_total, num_batches)
        nparts = num_batches * -(-t_total // chunk)
        ptrs += [d_trans, gself, gnext,
                 torch.empty((t_total, num_batches, num_labels), dtype=dt, device=dev),
                 torch.empty((t_total, num_batches, s_total), dtype=dt, device=dev),
                 torch.empty((nparts, num_labels, num_labels), dtype=dt, device=dev),
                 torch.empty((2, nparts, s_total), dtype=dt, device=dev)]
        sizes.append(chunk)
    else:
        ptrs += [torch.empty((num_batches, num_labels, num_labels), dtype=dt, device=dev),
                 d_trans, gself, gnext]
    stem = "asg_bwd_warp" if route == "warp" else "asg_bwd"
    fn = c_function("asg_bwd", stem, dt, len(ptrs), len(sizes))
    with torch.cuda.device(dev):
        err = fn(*map(ptr, ptrs), *sizes, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def _bwd_kernel(e, self_trans, next_trans, inputs, aligned, input_lengths,
                pb, qb, g_full, g_fac, *, route=None):
    """Launch K2 (csrc/asg_bwd.cu) on ``route`` ('warp', 'block', or None
    for ``width_route``).  Returns (gI, gA, dT, gself, gnext).  Counts each
    launch in ``common.LAUNCHES`` as ``K2`` and ``K2.<route>``."""
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    route = check_route("K2", route, max(num_labels, s_total))
    dev, dt = inputs.device, inputs.dtype
    (li,) = _lattice_args(e, self_trans, next_trans, inputs, aligned, input_lengths)
    g_full = g_full.to(device=dev, dtype=dt).contiguous()
    g_fac = g_fac.to(device=dev, dtype=dt).contiguous()
    for name, t, shape in (("pb", pb, (t_total, num_batches, num_labels)),
                           ("qb", qb, (t_total, num_batches, s_total)),
                           ("g_full", g_full, (num_batches,)),
                           ("g_fac", g_fac, (num_batches,))):
        check_tensor(name, t, dt, shape, dev)
    gi = torch.zeros((t_total, num_batches, num_labels), dtype=dt, device=dev)
    ga = torch.zeros((t_total, num_batches, s_total), dtype=dt, device=dev)
    d_trans = torch.empty((num_labels, num_labels), dtype=dt, device=dev)
    gself = torch.empty((num_batches, s_total), dtype=dt, device=dev)
    gnext = torch.empty((num_batches, s_total), dtype=dt, device=dev)
    if num_batches == 0:
        return gi, ga, d_trans.zero_(), gself, gnext
    _launch_bwd(route, e, self_trans, next_trans, inputs, aligned, li, pb, qb, g_full,
                g_fac, (gi, ga, d_trans, gself, gnext))
    count_launch("K2", route)
    return gi, ga, d_trans, gself, gnext


def _kernel_inputs(transition, inputs, targets, input_lengths, target_lengths):
    """(lattice, c, the arguments K1 takes)."""
    lat, e, c = _prepare(transition, inputs, targets, input_lengths, target_lengths)
    args = (e, lat.self_trans.contiguous(), lat.next_trans.contiguous(),
            inputs.contiguous(), lat.inputs.contiguous(), input_lengths,
            target_lengths)
    return lat, c, args


class _FusedScores(torch.autograd.Function):
    """K1 with stores forward, K2 + ``scatter_to_full`` backward."""

    @staticmethod
    def forward(ctx, transition, inputs, targets, input_lengths, target_lengths):
        lat, c, args = _kernel_inputs(transition, inputs, targets, input_lengths,
                                      target_lengths)
        run = _fwd_store_kernel if use_kernel(inputs, transition) else _fwd_store_plain
        pb, qb, sful, sfac = run(*args)
        e, self_trans, next_trans, inputs_c, aligned = args[:5]
        ctx.save_for_backward(e, self_trans, next_trans, inputs_c, aligned,
                              lat.targets, input_lengths, pb, qb)
        return _fix_scores(sful, sfac, input_lengths.to(inputs.device), c)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_full, g_fac):
        e, self_trans, next_trans, inputs, aligned, tgt, li, pb, qb = ctx.saved_tensors
        run = _bwd_kernel if use_kernel(inputs, e) else _bwd_plain
        gi, ga, d_trans, gself, gnext = run(e, self_trans, next_trans, inputs,
                                            aligned, li, pb, qb, g_full, g_fac)
        lat = AlignedLattice(aligned, self_trans, next_trans, tgt)
        gt_fac, gi_fac = scatter_to_full(lat, ga, gself, gnext, inputs.shape[2])
        return d_trans + gt_fac, gi + gi_fac, None, None, None


def asg_scores_fused(transition, inputs, targets, input_lengths, target_lengths):
    """(full_scores, aligned_scores), each (B,), from one pass of both beta
    chains: the kernels on CUDA tensors, their plain versions on CPU ones.

    A call that autograd will not differentiate (no input requires grad, or
    grad mode is off) runs K1 without stores and keeps no residuals.
    Otherwise the call runs K1 with stores, and ``backward`` runs K2.

    Launches are counted in ``common.LAUNCHES``: ``K1`` (without stores),
    ``K1s`` (with stores) and ``K2``, each also by route.
    """
    transition = transition.to(inputs.dtype)
    if wants_grad(transition, inputs):
        return _FusedScores.apply(transition, inputs, targets, input_lengths,
                                  target_lengths)
    _, c, args = _kernel_inputs(transition, inputs, targets, input_lengths,
                                target_lengths)
    run = _fwd_scores_kernel if use_kernel(inputs, transition) else _fwd_scores_plain
    sful, sfac = run(*args)
    return _fix_scores(sful, sfac, input_lengths.to(inputs.device), c)

