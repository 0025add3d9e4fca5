"""The fully-connected (denominator) lattice's per-lattice kernels: the
log-domain alpha and beta chains together (K3), the beta chain alone (K4)
and the backward (K5).

``fcc_score_pallas`` is the FCC half of the per-lattice tier
(``impl='pallas'``).  Every step's logsumexp over transitions is an
m-normalised exp-domain contraction against ``E = exp(T - c)``, with ``c``
the max finite transition (0 when there is none):
    lse_j(x[j] + T[j, i]) = m + log(sum_j exp(x[j] - m) E[j, i]) + c,
where ``m`` is the row max, taken as 0 on an all--inf row, and
``log(0) = -inf`` keeps dead labels dead.  The chains stay in the log
domain: alpha[t] = I[t] + lse(alpha[t-1] + T) from alpha[0] = I[0], beta
seeded 0 at ``t = L_in - 1``; frames at ``t >= L_in`` hold -inf.  An element
with L_in outside [1, T] is never seeded and scores -inf.

A call that autograd will not differentiate runs K4 alone and scores
``lse(beta[0] + I[0])``.  Otherwise ``_FccPallas`` runs K3 forward, which
keeps alpha and beta, and K5 backward:
    dI = softmax(alpha + beta) * g                          (per frame)
    dT = (sum_{t,b} u^T v) * E,  v = exp(alpha[t-1] - m_{t-1}),
         u = dI * exp(where(alpha finite, I - alpha, -inf) + m_{t-1} + c).
u's exponent is bounded by the transition spread, which the 60-nat guard of
``asg.py`` polices.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/fcc.cu``; on CPU tensors they run the plain versions beside them,
step-by-step loops of the same arithmetic.  K3, K4 and K5 each have two
routes with the same outputs, chosen by ``common.width_route`` of the
label count: up to ``common.WARP_MAX_WIDTH`` labels the warp route, past it
the block route (one thread per label, one block per element walking its
frames).  K3's warp route walks each chain
on a warp of its own in the exp domain with a per-step rescale, writing
raw rows and per-frame offsets that a frame-parallel pass turns into the
log-domain rows (``_fcc_fwd_warp_plain`` is its arithmetic in torch);
K4's warp route is K3's beta warp alone, then the same pass for beta
(``_fcc_beta_warp_plain``).
K5's warp route has no walk: a kernel parallel over (element, chunk of
frames) computes the posteriors and per-chunk transition partials, and a
second sums them in a fixed order (``_fcc_bwd_split_plain``).  These
mirrors are used by the tests; CPU tensors run the plain versions.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .bigvocab_kernels import _exp_mats
from .common import (KERNEL_DTYPES, c_function, check_route, check_tensor,
                     count_launch, exp_rows, post_chunk, ptr, raise_on_error,
                     softmax_rows, stream_ptr, use_kernel, wants_grad)
from ..semiring import NEG_INF, logsumexp

# Widest label set the kernels' one-thread-per-label block takes (the
# per-lattice tier's cap in ``asg.py``).
PER_LATTICE_MAX_WIDTH = 512


def _prepare(transition, inputs, input_lengths):
    """(E = exp(T - c), c as a 0-d tensor, contiguous inputs, int32 lengths)."""
    e, c = _exp_mats(transition, inputs.dtype)
    li = input_lengths.to(device=inputs.device, dtype=torch.int32)
    return e, c, inputs.contiguous(), li


def _lse_step(x, mat, c):
    """m-normalised exp-matmul logsumexp: lse_j(x[b, j] + log mat[j, i]) + c."""
    m = torch.amax(x, dim=1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m_safe + torch.log(torch.exp(x - m_safe) @ mat) + c


def _beta_rows(e, c, inputs, li):
    """The beta chain (T, B, N), t descending: the "I[T]" row is -inf, so
    frame T - 1 is the seed or -inf."""
    t_total = inputs.shape[0]
    out = torch.empty_like(inputs)
    zeros = torch.zeros_like(inputs[0])
    b = torch.where(li - 1 == t_total - 1, zeros, NEG_INF)
    out[t_total - 1] = b
    for t in range(t_total - 2, -1, -1):
        i_next = inputs[t + 1].masked_fill(~(li > t + 1), NEG_INF)
        raw = _lse_step(i_next + b, e, c)
        b = torch.where(li - 1 == t, zeros, raw)
        out[t] = b
    return out


def fcc_fwd_plain(e, c, inputs, input_lengths):
    """Plain version of K3: (alpha, beta), each (T, B, N), log domain."""
    li = input_lengths.to(device=inputs.device, dtype=torch.long)[:, None]
    alpha = torch.empty_like(inputs)
    e_t = e.T
    a = None
    for t in range(inputs.shape[0]):
        i_t = inputs[t].masked_fill(~(li > t), NEG_INF)
        a = i_t if t == 0 else i_t + _lse_step(a, e_t, c)
        alpha[t] = a
    return alpha, _beta_rows(e, c, inputs, li)


def fcc_beta_plain(e, c, inputs, input_lengths):
    """Plain version of K4: beta (T, B, N), log domain."""
    li = input_lengths.to(device=inputs.device, dtype=torch.long)[:, None]
    return _beta_rows(e, c, inputs, li)


def fcc_bwd_plain(e, c, inputs, input_lengths, alpha, beta, g):
    """Plain version of K5: (dI (T, B, N), dT (N, N)).

    Walks t from 0 up: the posterior dI_t = softmax(alpha_t + beta_t) * g
    (all--inf rows give zeros), and acc += u_t^T v_t with v_t the previous
    alpha row exponentiated against its own max (zeros at t = 0); after the
    walk dT = acc * E."""
    li = input_lengths.to(device=inputs.device, dtype=torch.long)[:, None]
    g = g.to(inputs.dtype)[:, None]
    gi_all = torch.empty_like(inputs)
    acc = torch.zeros_like(e)
    a_prev = torch.full_like(inputs[0], NEG_INF)
    for t in range(inputs.shape[0]):
        a_cur = alpha[t]
        gamma = a_cur + beta[t]
        m = torch.amax(gamma, dim=1, keepdim=True)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        ex = torch.exp(gamma - m_safe)
        denom = torch.sum(ex, dim=1, keepdim=True)
        gi = ex / torch.where(denom == 0.0, torch.ones_like(denom), denom) * g
        gi_all[t] = gi
        i_t = inputs[t].masked_fill(~(li > t), NEG_INF)
        mp = torch.amax(a_prev, dim=1, keepdim=True)
        mp_safe = torch.where(torch.isfinite(mp), mp, torch.zeros_like(mp))
        v = torch.exp(a_prev - mp_safe)
        u_expo = torch.where(torch.isfinite(a_cur), i_t - a_cur, NEG_INF)
        u = gi * torch.exp(u_expo + mp_safe + c)
        acc += u.T @ v
        a_prev = a_cur
    return gi_all, acc * e


def _rescale(x):
    """(x / m, log m) with m the row max, 1 where the max is not positive."""
    m = torch.amax(x, dim=1)
    m_s = torch.where(m > 0, m, torch.ones_like(m))
    return x / m_s[:, None], torch.log(m_s)


def _fcc_beta_warp_plain(e, c, inputs, input_lengths):
    """Plain version of K4's warp route (K3's beta warp alone, then the log
    pass): ``fcc_beta_plain``'s output from an exp-domain chain with a
    per-step rescale.  Used by the tests; the main path runs
    ``fcc_beta_plain`` on CPU tensors.

    t descending from the seed pb_{L-1} = 1: y_t = (pb_{t+1} * exp(I_{t+1}
    - max I_{t+1})) @ E, pb_t = y_t rescaled to max 1, beta_t = log y_t +
    (offset of pb_{t+1} + max I_{t+1} + c).  The chain keeps the raw rows
    and the per-frame offsets; a last pass takes the logs and writes -inf
    on the rows that are not live (t >= L, every row when L is outside
    [1, T]).
    """
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    li = input_lengths.to(device=dev, dtype=torch.long)
    raw = torch.empty_like(inputs)
    off = torch.empty((t_total, num_batches), dtype=dt, device=dev)
    ones = torch.ones((num_batches, num_labels), dtype=dt, device=dev)
    # seeded at t = L - 1, where the walk restarts
    pb = ones
    b_off = torch.zeros((num_batches,), dtype=dt, device=dev)
    for t in range(t_total - 1, -1, -1):
        seed = (li - 1 == t)[:, None]
        if t == t_total - 1:
            y, o = ones, torch.zeros_like(b_off)
        else:
            ex, m = exp_rows(inputs[t + 1])
            y, o = (pb * ex) @ e, b_off + m + c
        y, o = torch.where(seed, ones, y), torch.where(seed[:, 0], 0.0, o)
        raw[t], off[t] = y, o
        pb, log_m = _rescale(y)
        b_off = o + log_m
    rows = torch.arange(t_total, device=dev)[:, None, None]
    live = (rows < li[None, :, None]) & (li <= t_total)[None, :, None]
    return torch.where(live, torch.log(raw) + off[..., None], NEG_INF)


def _fcc_fwd_warp_plain(e, c, inputs, input_lengths):
    """Plain version of K3's warp route: ``fcc_fwd_plain``'s outputs from
    exp-domain chains with a per-step rescale.  Used by the tests; the main
    path runs ``fcc_fwd_plain`` on CPU tensors.

    alpha, t ascending: s_t = pa_{t-1} @ E^T (s_0 = 1), pa_t = s_t *
    exp(I_t - max I_t) rescaled to max 1, and A_t, the log-scale offset of
    pa_t, beside the chain; alpha_t = I_t + log s_t + (A_{t-1} + c), -inf on
    the rows t >= min(L, T).  beta is ``_fcc_beta_warp_plain``'s, K3's
    beta warp being K4's.
    """
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    li = input_lengths.to(device=dev, dtype=torch.long)
    raw_a = torch.empty_like(inputs)
    off_a = torch.empty((t_total, num_batches), dtype=dt, device=dev)
    # every element walks all T frames; rows past its length are masked
    ones = torch.ones((num_batches, num_labels), dtype=dt, device=dev)
    pa, a_off = None, None
    for t in range(t_total):
        ex, m = exp_rows(inputs[t])
        s = ones if t == 0 else pa @ e.T
        o = torch.zeros_like(m) if t == 0 else a_off + c
        raw_a[t], off_a[t] = s, o
        pa, log_m = _rescale(s * ex)
        a_off = o + m + log_m
    live_a = torch.arange(t_total, device=dev)[:, None, None] < li[None, :, None]
    alpha = torch.where(live_a, inputs + torch.log(raw_a) + off_a[..., None], NEG_INF)
    return alpha, _fcc_beta_warp_plain(e, c, inputs, input_lengths)


def _fcc_bwd_split_plain(e, c, inputs, input_lengths, alpha, beta, g, chunk=None):
    """Plain version of K5's warp route: ``fcc_bwd_plain``'s outputs with no
    walk over the frames.  Used by the tests; the main path runs
    ``fcc_bwd_plain`` on CPU tensors.

    1. Posteriors per (element, chunk of ``chunk`` frames; default
       ``post_chunk``): frame t needs rows t of alpha, beta, I and row t-1
       of alpha.  dI_t = softmax(alpha_t + beta_t) * g; the chunk's (N, N)
       partial is the sum over its frames t >= 1 of u_t outer v_t, with
       v_t = exp(alpha_{t-1} - m_{t-1}) and u_t = dI_t * exp(where(alpha_t
       finite, I_t - alpha_t, -inf) + m_{t-1} + c).
    2. dT = (sum of the partials) * E.
    Frames t >= L_in, and every frame of an element with L_in outside
    [1, T], contribute nothing.
    """
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    if chunk is None:
        chunk = post_chunk(t_total, num_batches)
    li = input_lengths.to(device=dev, dtype=torch.long)
    bad = (li < 1) | (li > t_total)
    live = (torch.arange(t_total, device=dev)[:, None] < li[None, :]) & ~bad[None, :]
    live = live[..., None]  # (T, B, 1)

    # ---- 1: posteriors and per-chunk partials
    gi = torch.where(live, softmax_rows(alpha + beta) * g.to(dt)[:, None], 0.0)
    m = torch.amax(alpha, dim=2, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    v = torch.exp(alpha - m)
    u_expo = torch.where(torch.isfinite(alpha[1:]), inputs[1:] - alpha[1:], NEG_INF)
    u = torch.where(live[1:], gi[1:] * torch.exp(u_expo + m[:-1] + c), 0.0)  # frames 1..
    nchunks = -(-t_total // chunk)
    part = torch.zeros((num_batches, nchunks, num_labels, num_labels), dtype=dt, device=dev)
    for k in range(nchunks):
        lo, hi = max(k * chunk, 1), min((k + 1) * chunk, t_total)
        part[:, k] = torch.einsum("tbi,tbj->bij", u[lo - 1:hi - 1], v[lo - 1:hi - 1])

    # ---- 2: the sums
    return gi, part.sum(dim=(0, 1)) * e


def _check(e, c, inputs, li):
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"FCC kernels take float32 or float64, got {dt}")
    if num_labels > PER_LATTICE_MAX_WIDTH:
        raise ValueError(f"FCC kernels take num_labels <= {PER_LATTICE_MAX_WIDTH}; "
                         f"got {num_labels}")
    check_tensor("e", e, dt, (num_labels, num_labels), dev)
    check_tensor("c", c, dt, (), dev)
    check_tensor("inputs", inputs, dt, (t_total, num_batches, num_labels), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)


def _launch_fwd(route, e, c, inputs, li, outs):
    """Launch K3 on ``route`` with the outputs ``outs`` (alpha, beta):
    ``fcc_fwd_{f32,f64}`` (the block route, E^T beside E) or
    ``fcc_fwd_warp_{f32,f64}`` (the chains, then the log pass, with a
    (2, T, B) scratch of per-frame offsets between them)."""
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    if route == "warp":
        ptrs = [inputs, e, c, li, *outs,
                torch.empty((2, t_total, num_batches), dtype=dt, device=dev)]
    else:
        ptrs = [inputs, e, e.T.contiguous(), c, li, *outs]
    sizes = [t_total, num_batches, num_labels]
    stem = "fcc_fwd_warp" if route == "warp" else "fcc_fwd"
    fn = c_function("fcc", stem, dt, len(ptrs), len(sizes))
    with torch.cuda.device(dev):
        err = fn(*map(ptr, ptrs), *sizes, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def fcc_fwd_pallas(e, c, inputs, input_lengths, *, route=None):
    """(alpha, beta), each (T, B, N): K3 on CUDA tensors, on ``route``
    ('warp', 'block', or None for ``width_route`` of the label count), and
    its plain version on CPU ones.  Counts each launch in
    ``common.LAUNCHES`` as ``K3`` and ``K3.<route>``."""
    route = check_route("K3", route, inputs.shape[2])
    if not use_kernel(inputs, e, c, input_lengths):
        return fcc_fwd_plain(e, c, inputs, input_lengths)
    li = input_lengths.to(torch.int32).contiguous()
    e = e.contiguous()
    _check(e, c, inputs, li)
    alpha, beta = torch.empty_like(inputs), torch.empty_like(inputs)
    if alpha.numel() == 0:
        return alpha, beta
    _launch_fwd(route, e, c, inputs, li, (alpha, beta))
    count_launch("K3", route)
    return alpha, beta


def _launch_beta(route, e, c, inputs, li, beta):
    """Launch K4 on ``route`` with the output ``beta``: ``fcc_beta_{f32,f64}``
    (the block route) or ``fcc_beta_warp_{f32,f64}`` (the chain, then the
    log pass, with a (T, B) scratch of per-frame offsets between them)."""
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    ptrs = [inputs, e, c, li, beta]
    if route == "warp":
        ptrs.append(torch.empty((t_total, num_batches), dtype=dt, device=dev))
    stem = "fcc_beta_warp" if route == "warp" else "fcc_beta"
    fn = c_function("fcc", stem, dt, len(ptrs), 3)
    with torch.cuda.device(dev):
        err = fn(*map(ptr, ptrs), t_total, num_batches, num_labels, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def fcc_beta_pallas(e, c, inputs, input_lengths, *, route=None):
    """beta (T, B, N): K4 on CUDA tensors, on ``route`` ('warp', 'block', or
    None for ``width_route`` of the label count), and its plain version on
    CPU ones.  Counts each launch in ``common.LAUNCHES`` as ``K4`` and
    ``K4.<route>``."""
    route = check_route("K4", route, inputs.shape[2])
    if not use_kernel(inputs, e, c, input_lengths):
        return fcc_beta_plain(e, c, inputs, input_lengths)
    li = input_lengths.to(torch.int32).contiguous()
    e = e.contiguous()
    _check(e, c, inputs, li)
    beta = torch.empty_like(inputs)
    if beta.numel() == 0:
        return beta
    _launch_beta(route, e, c, inputs, li, beta)
    count_launch("K4", route)
    return beta


def _launch_bwd(route, e, c, inputs, li, alpha, beta, g, outs):
    """Launch K5 on ``route`` with the outputs ``outs`` (dI, dT) and the
    route's scratch for the transition partials: ``fcc_bwd_{f32,f64}``
    (the block route, (B, N, N)) or ``fcc_bwd_warp_{f32,f64}`` ((chunks *
    B, N, N), chunks of ``post_chunk`` frames: the posterior kernel, then
    the sums)."""
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    gi, d_trans = outs
    sizes = [t_total, num_batches, num_labels]
    if route == "warp":
        chunk = post_chunk(t_total, num_batches)
        nparts = num_batches * -(-t_total // chunk)
        part = torch.empty((nparts, num_labels, num_labels), dtype=dt, device=dev)
        ptrs = [inputs, e, c, li, alpha, beta, g, gi, d_trans, part]
        sizes.append(chunk)
    else:
        part = torch.empty((num_batches, num_labels, num_labels), dtype=dt, device=dev)
        ptrs = [inputs, e, c, li, alpha, beta, g, gi, part, d_trans]
    stem = "fcc_bwd_warp" if route == "warp" else "fcc_bwd"
    fn = c_function("fcc", stem, dt, len(ptrs), len(sizes))
    with torch.cuda.device(dev):
        err = fn(*map(ptr, ptrs), *sizes, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def fcc_bwd_pallas(e, c, inputs, input_lengths, alpha, beta, g, *, route=None):
    """(dI (T, B, N), dT (N, N)): K5 on CUDA tensors, on ``route`` ('warp',
    'block', or None for ``width_route`` of the label count), and its plain
    version on CPU ones.  Both routes sum the transition partials (per
    element, or per (element, chunk of frames)) in a fixed order, so two
    runs give the same bits.  Counts each launch in ``common.LAUNCHES``
    as ``K5`` and ``K5.<route>``."""
    route = check_route("K5", route, inputs.shape[2])
    if not use_kernel(inputs, e, c, input_lengths, alpha, beta, g):
        return fcc_bwd_plain(e, c, inputs, input_lengths, alpha, beta, g)
    li = input_lengths.to(torch.int32).contiguous()
    e = e.contiguous()
    _check(e, c, inputs, li)
    num_batches = inputs.shape[1]
    dev, dt = inputs.device, inputs.dtype
    g = g.to(dt).contiguous()
    check_tensor("alpha", alpha, dt, inputs.shape, dev)
    check_tensor("beta", beta, dt, inputs.shape, dev)
    check_tensor("g", g, dt, (num_batches,), dev)
    gi = torch.empty_like(inputs)
    d_trans = torch.empty_like(e)
    if gi.numel() == 0:
        return gi, d_trans.zero_()
    _launch_bwd(route, e, c, inputs, li, alpha, beta, g, (gi, d_trans))
    count_launch("K5", route)
    return gi, d_trans


def _score(beta0, inputs0):
    # every path starts at t = 0, which is valid for every seeded element
    return logsumexp(beta0 + inputs0, dim=1)


class _FccPallas(torch.autograd.Function):
    """K3 forward (alpha and beta kept), K5 backward."""

    @staticmethod
    def forward(ctx, transition, inputs, input_lengths):
        e, c, inputs, li = _prepare(transition, inputs, input_lengths)
        alpha, beta = fcc_fwd_pallas(e, c, inputs, li)
        ctx.save_for_backward(e, c, inputs, li, alpha, beta)
        return _score(beta[0], inputs[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        e, c, inputs, li, alpha, beta = ctx.saved_tensors
        grad_inputs, grad_transition = fcc_bwd_pallas(e, c, inputs, li, alpha, beta, g)
        return grad_transition, grad_inputs, None


def fcc_score_pallas(transition: torch.Tensor, inputs: torch.Tensor,
                     input_lengths: torch.Tensor) -> torch.Tensor:
    """Per-lattice denominator scores, shape (B,); same contract as
    ``ops.fcc.fcc_score``.  A call that autograd will not differentiate runs
    K4 alone; otherwise K3 forward and K5 backward."""
    transition = transition.to(inputs.dtype)
    if wants_grad(transition, inputs):
        return _FccPallas.apply(transition, inputs, input_lengths)
    e, c, inputs, li = _prepare(transition, inputs, input_lengths)
    beta = fcc_beta_pallas(e, c, inputs, li)
    return _score(beta[0], inputs[0])

