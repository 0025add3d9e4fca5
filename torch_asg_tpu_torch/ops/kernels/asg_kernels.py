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
step-by-step loops of the same arithmetic.

Numeric domains: the FCC chains run in the exp domain with a per-step
rescale to max 1 and the log-maxes summed into an offset (full connectivity
bounds a row's spread by one step's emission + transition spread, which the
60-nat guard in ``asg.py`` keeps inside the fp32 exp range).  The FAC chains
stay in the log domain, because an aligned row's spread grows with
``|s - t*S/T|``.  The gradients use only log-space softmaxes and exps of
exponents <= 0.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .common import (KERNEL_DTYPES, check_tensor, ptr, raise_on_error,
                     stream_ptr, use_kernel, wants_grad)
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


def _exp_rows(x):
    """(exp(x - rowmax), rowmax) with all--inf rows mapping to (0, 0)."""
    m = torch.amax(x, dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.exp(x - m[:, None]), m


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
        ex_n, m_n = _exp_rows(row)
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
        gi = _softmax_rows(lpa + torch.log(pb[t])) * g_full
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
        gq = _softmax_rows(qa_new + qb[t]) * g_fac
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


def _softmax_rows(x):
    """Row softmax with all--inf rows giving zeros, as the kernel takes it:
    exp(x - max) times the reciprocal of the row sum."""
    m = torch.amax(x, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(x - m)
    den = torch.sum(ex, dim=-1, keepdim=True)
    return ex * (1.0 / torch.where(den > 0, den, torch.ones_like(den)))


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


def _fwd_scores_kernel(e, self_trans, next_trans, inputs, aligned,
                       input_lengths, target_lengths):
    """Launch ``asg_fwd_scores_{f32,f64}`` (csrc/asg_fwd.cu): K1 without
    stores."""
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    li, lo = _lattice_args(e, self_trans, next_trans, inputs, aligned,
                           input_lengths, target_lengths)
    sful = torch.empty((num_batches,), dtype=dt, device=dev)
    sfac = torch.empty((num_batches,), dtype=dt, device=dev)
    if num_batches == 0:
        return sful, sfac
    fn = _c_fn("asg_fwd", "asg_fwd_scores", dt, 9)
    with torch.cuda.device(dev):
        err = fn(ptr(inputs), ptr(aligned), ptr(e), ptr(self_trans),
                 ptr(next_trans), ptr(li), ptr(lo), ptr(sful), ptr(sfac),
                 t_total, num_batches, num_labels, s_total, stream_ptr(dev))
    raise_on_error(fn.__name__, err)
    asg_scores_fused.launches += 1
    return sful, sfac


def _fwd_store_kernel(e, self_trans, next_trans, inputs, aligned,
                      input_lengths, target_lengths):
    """Launch ``asg_fwd_store_{f32,f64}`` (csrc/asg_fwd.cu): K1 with stores.
    Returns (PB, QB, sful, sfac); the kernel writes residual rows
    t < L_in[b] and this wrapper fills the rest with the semiring zeros."""
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    li, lo = _lattice_args(e, self_trans, next_trans, inputs, aligned,
                           input_lengths, target_lengths)
    pb = torch.zeros((t_total, num_batches, num_labels), dtype=dt, device=dev)
    qb = torch.full((t_total, num_batches, s_total), NEG_INF, dtype=dt, device=dev)
    sful = torch.empty((num_batches,), dtype=dt, device=dev)
    sfac = torch.empty((num_batches,), dtype=dt, device=dev)
    if num_batches == 0:
        return pb, qb, sful, sfac
    fn = _c_fn("asg_fwd", "asg_fwd_store", dt, 11)
    with torch.cuda.device(dev):
        err = fn(ptr(inputs), ptr(aligned), ptr(e), ptr(self_trans),
                 ptr(next_trans), ptr(li), ptr(lo), ptr(pb), ptr(qb), ptr(sful),
                 ptr(sfac), t_total, num_batches, num_labels, s_total,
                 stream_ptr(dev))
    raise_on_error(fn.__name__, err)
    _fwd_store_kernel.launches += 1
    return pb, qb, sful, sfac


def _bwd_kernel(e, self_trans, next_trans, inputs, aligned, input_lengths,
                pb, qb, g_full, g_fac):
    """Launch ``asg_bwd_{f32,f64}`` (csrc/asg_bwd.cu): K2.  Returns (gI, gA,
    dT, gself, gnext).  The per-element (N, N) transition partials go to a
    (B, N, N) scratch that a second kernel sums in a fixed order."""
    t_total, num_batches, num_labels = inputs.shape
    s_total = aligned.shape[2]
    dev, dt = inputs.device, inputs.dtype
    (li,) = _lattice_args(e, self_trans, next_trans, inputs, aligned, input_lengths)
    g_full = g_full.to(device=dev, dtype=dt).contiguous()
    g_fac = g_fac.to(device=dev, dtype=dt).contiguous()
    for name, t, shape in (("pb", pb, (t_total, num_batches, num_labels)),
                           ("qb", qb, (t_total, num_batches, s_total)),
                           ("g_full", g_full, (num_batches,)),
                           ("g_fac", g_fac, (num_batches,))):
        check_tensor(name, t, dt, shape, dev)
    e_t = e.T.contiguous()
    gi = torch.zeros((t_total, num_batches, num_labels), dtype=dt, device=dev)
    ga = torch.zeros((t_total, num_batches, s_total), dtype=dt, device=dev)
    d_trans = torch.empty((num_labels, num_labels), dtype=dt, device=dev)
    gself = torch.empty((num_batches, s_total), dtype=dt, device=dev)
    gnext = torch.empty((num_batches, s_total), dtype=dt, device=dev)
    if num_batches == 0:
        return gi, ga, d_trans.zero_(), gself, gnext
    partial = torch.empty((num_batches, num_labels, num_labels), dtype=dt, device=dev)
    fn = _c_fn("asg_bwd", "asg_bwd", dt, 17)
    with torch.cuda.device(dev):
        err = fn(ptr(inputs), ptr(aligned), ptr(e), ptr(e_t), ptr(self_trans),
                 ptr(next_trans), ptr(li), ptr(pb), ptr(qb), ptr(g_full),
                 ptr(g_fac), ptr(gi), ptr(ga), ptr(partial), ptr(d_trans),
                 ptr(gself), ptr(gnext), t_total, num_batches, num_labels,
                 s_total, stream_ptr(dev))
    raise_on_error(fn.__name__, err)
    _bwd_kernel.launches += 1
    return gi, ga, d_trans, gself, gnext


def _c_fn(lib, stem, dtype, num_ptrs):
    """The C entry point ``<stem>_{f32,f64}`` of ``csrc/<lib>.cu``: pointer
    arguments, then the four sizes (T, B, N, S), then the stream."""
    from ._build import load

    fn = getattr(load(lib), f"{stem}_f32" if dtype == torch.float32 else f"{stem}_f64")
    fn.argtypes = [ctypes.c_void_p] * num_ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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

    Launch counts: ``asg_scores_fused.launches`` (K1 without stores),
    ``_fwd_store_kernel.launches`` (K1 with stores) and
    ``_bwd_kernel.launches`` (K2).
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


asg_scores_fused.launches = 0
_fwd_store_kernel.launches = 0
_bwd_kernel.launches = 0
