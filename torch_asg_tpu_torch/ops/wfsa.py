"""Generic weighted-FSA scoring over emission lattices (PyTorch).

Scores any epsilon-free weighted finite-state acceptor against a (T, B, N)
emission lattice in the log or the tropical semiring.  The two ASG lattices
are its extreme cases: the fully-connected denominator is the N-state
complete automaton (``full_wfsa``, equal to ``fcc_score``) and the
force-aligned numerator the linear chain over the target (``chain_wfsa``,
equal to ``fac_score``).  Lexicons (``lexicon_wfsa``), n-gram grammars and
decoding graphs exported from a WFST toolkit as arc arrays score through the
same entry points.

One frame consumes one arc: the arc scores (B, E) are
``alpha[:, src] + weight + I[t, :, ilabel]``, reduced into their
destination states by a log-semiring sum (``wfsa_score``) or a max with the
lowest arc id winning ties (``wfsa_viterbi``).  ``wfsa_posteriors``
differentiates the score with autograd.

Every reduction sums in a fixed order, so two runs give the same bits on
every device (``index_add_``, ``scatter_add_``, ``scatter_reduce`` and the
backward of ``gather`` / ``index_select`` use atomics on CUDA).  Each index
array of the graph gets a plan, built once on the host and kept while the
index tensor lives unchanged (``_plan``): the members of each segment
(the incoming arcs of a state, the arcs leaving a state, the arcs of a
label) in ascending order, in padded tables grouped by member count, so a
skewed graph (a looped lexicon's word starts take one arc from every word
end) pads each group only to its own widest segment.  Forward reductions
gather a table and reduce its rows; the backward of each column gather sums
the gradient through the table of its index (``_Take``), and the backward
of the log-semiring reduction is a softmax computed from its saved arc
scores (``_SegmentLSE``), so autograd keeps one (B, E) tensor a frame.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .kernels.viterbi_kernels import argmax_first
from .semiring import NEG_INF, logsumexp
from ..utils.lengths import default_lengths

_INT32_MIN = -(2 ** 31)
_INT32_MAX = 2 ** 31 - 1


class WFSA(NamedTuple):
    """Epsilon-free weighted acceptor (log-domain weights).

    States are 0..num_states-1.  Arc e accepts emission label ``ilabel[e]``
    moving ``src[e] -> dst[e]`` with weight ``weight[e]``.  ``start`` /
    ``final`` are (num_states,) log-weights (-inf = absent).  Every path
    consumes exactly one emission frame per arc.  The arc arrays are read
    as constants: a plan built from them is kept while they are unchanged.
    """

    src: torch.Tensor  # (E,) int32
    dst: torch.Tensor  # (E,) int32
    ilabel: torch.Tensor  # (E,) int32 emission labels
    weight: torch.Tensor  # (E,) float
    start: torch.Tensor  # (S,) float log start weights
    final: torch.Tensor  # (S,) float log final weights

    @property
    def num_states(self) -> int:
        return self.start.shape[0]

    @property
    def num_arcs(self) -> int:
        return self.src.shape[0]


def _ends(n, at, dtype, device, fill):
    out = torch.full((n,), fill, dtype=dtype, device=device)
    out[at] = 0.0
    return out


def chain_wfsa(labels: torch.Tensor, self_weights: torch.Tensor,
               next_weights: torch.Tensor) -> WFSA:
    """The force-aligned linear chain for ONE target sequence: state s
    self-loops with ``self_weights[s]`` and advances s -> s+1 with
    ``next_weights[s]``, emitting ``labels[s]`` / ``labels[s+1]``.  A
    super-initial state sigma feeds state 0 with a free arc emitting
    ``labels[0]``: frame 0 carries no transition score, as in the lattice."""
    n = labels.shape[0]
    dt, dev = self_weights.dtype, self_weights.device
    labels = labels.to(dev)
    ar = torch.arange(n, device=dev)
    sigma = torch.tensor([n], device=dev)
    src = torch.cat([sigma, ar, ar[:-1]]).to(torch.int32)
    dst = torch.cat([torch.zeros(1, dtype=ar.dtype, device=dev), ar, ar[1:]]).to(torch.int32)
    ilab = torch.cat([labels[:1], labels, labels[1:]]).to(torch.int32)
    w = torch.cat([torch.zeros(1, dtype=dt, device=dev), self_weights,
                   next_weights[: n - 1].to(dt)])
    return WFSA(src, dst, ilab, w, _ends(n + 1, n, dt, dev, NEG_INF),
                _ends(n + 1, n - 1, dt, dev, NEG_INF))


def full_wfsa(transition: torch.Tensor) -> WFSA:
    """The fully-connected automaton of the ASG denominator: state i emits
    label i; arc j -> i carries ``transition[i, j]``; a super-initial state
    feeds every label with weight 0."""
    n = transition.shape[0]
    dt, dev = transition.dtype, transition.device
    ii, jj = torch.meshgrid(torch.arange(n, device=dev), torch.arange(n, device=dev),
                            indexing="ij")
    src = torch.cat([torch.full((n,), n, device=dev), jj.reshape(-1)]).to(torch.int32)
    dst = torch.cat([torch.arange(n, device=dev), ii.reshape(-1)]).to(torch.int32)
    w = torch.cat([torch.zeros(n, dtype=dt, device=dev), transition.reshape(-1)])
    final = torch.zeros(n + 1, dtype=dt, device=dev)
    final[n] = NEG_INF
    return WFSA(src, dst, dst, w, _ends(n + 1, n, dt, dev, NEG_INF), final)


def _host(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def lexicon_wfsa(transition: torch.Tensor, words, word_weights=None,
                 loop: bool = False) -> WFSA:
    """Union-of-chains acceptor over a pronunciation lexicon.

    ``words`` is a list of 1-D label sequences (ASG-encoded).  Each word
    becomes a linear chain (self-loop ``T[y, y]``, advance
    ``T[y_{k+1}, y_k]``); a shared super-initial state feeds every word's
    first state with ``word_weights[w]`` (frame 0 carries no transition
    score).  Accepting states are the word ends.  ``loop=True`` also joins
    every word end to every word start (weight ``word_weights[w'] +
    T[first(w'), last(w)]``) for continuous recognition.

    The graph is built on the host in NumPy; the arrays are returned on the
    transition's device.
    """
    if not words:
        raise ValueError("lexicon_wfsa needs at least one word")
    words = [_host(w, np.int32).reshape(-1) for w in words]
    if any(w.size == 0 for w in words):
        raise ValueError("empty word in lexicon")
    trans_np = _host(transition)
    dt = trans_np.dtype
    if word_weights is None:
        word_weights = np.zeros((len(words),), dt)
    word_weights = _host(word_weights, dt)

    offsets = np.cumsum([0] + [w.size for w in words])[:-1]
    num_states = int(sum(w.size for w in words)) + 1
    sigma = num_states - 1

    src, dst, ilab, wt = [], [], [], []
    for w, off, ww in zip(words, offsets, word_weights):
        ks = np.arange(w.size, dtype=np.int32) + off
        src.append([sigma]); dst.append([ks[0]]); ilab.append([w[0]]); wt.append([ww])
        src.append(ks); dst.append(ks); ilab.append(w); wt.append(trans_np[w, w])
        src.append(ks[:-1]); dst.append(ks[1:]); ilab.append(w[1:])
        wt.append(trans_np[w[1:], w[:-1]])
    if loop:
        lasts = [off + w.size - 1 for w, off in zip(words, offsets)]
        for w_from, last in zip(words, lasts):
            for w_to, off_to, ww in zip(words, offsets, word_weights):
                src.append([last]); dst.append([off_to]); ilab.append([w_to[0]])
                wt.append([ww + trans_np[w_to[0], w_from[-1]]])

    start = np.full((num_states,), -np.inf, dt)
    start[sigma] = 0.0
    final = np.full((num_states,), -np.inf, dt)
    for w, off in zip(words, offsets):
        final[off + w.size - 1] = 0.0

    def cat(parts, t):
        return torch.from_numpy(np.concatenate([np.asarray(p) for p in parts]).astype(t)
                                ).to(transition.device)

    return WFSA(cat(src, np.int32), cat(dst, np.int32), cat(ilab, np.int32), cat(wt, dt),
                torch.from_numpy(start).to(transition.device),
                torch.from_numpy(final).to(transition.device))


# --- plans: fixed-order segment tables, one per index tensor -----------------


class _Plan(NamedTuple):
    """Segments 0..M-1 over the positions of an index array ``idx``
    (segment c holds the positions k with ``idx[k] == c``, ascending).

    ``gather``: ``idx`` with entries outside [0, M) replaced by M, a column
    the gather fills (JAX's ``take`` fill for out-of-range indices).
    ``members``: the segments' positions, bucket after bucket, each bucket a
    row-major (rows, width) table padded with K = len(idx), the sentinel.
    ``shapes``: (rows, width) per bucket.  ``order[c]``: the column of
    segment c among the buckets' concatenated rows.  ``empty``: segments
    with no member."""

    gather: torch.Tensor
    has_fill: bool
    members: torch.Tensor
    shapes: tuple
    order: torch.Tensor
    empty: torch.Tensor


def _build_plan(idx: torch.Tensor, num_segments: int) -> _Plan:
    dev = idx.device
    seg = idx.detach().cpu().numpy().astype(np.int64).reshape(-1)
    k = seg.size
    inside = (seg >= 0) & (seg < num_segments)
    pos = np.nonzero(inside)[0]
    seg_in = seg[inside]
    by_seg = np.argsort(seg_in, kind="stable")  # ascending position within a segment
    seg_sorted, pos_sorted = seg_in[by_seg], pos[by_seg]
    counts = np.bincount(seg_in, minlength=num_segments)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(seg_sorted.size) - starts[seg_sorted]
    # bucket b holds the segments of 2^(b-1) < count <= 2^b members (0 and 1
    # together), each padded to the bucket's widest
    bucket = np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
    members, shapes = [], []
    order = np.empty(num_segments, np.int64)
    col = 0
    for b in np.unique(bucket):
        segs = np.nonzero(bucket == b)[0]
        width = max(int(counts[segs].max()), 1)
        row = np.full(num_segments, -1, np.int64)
        row[segs] = np.arange(segs.size)
        table = np.full((segs.size, width), k, np.int64)
        sel = bucket[seg_sorted] == b
        table[row[seg_sorted[sel]], rank[sel]] = pos_sorted[sel]
        members.append(table.reshape(-1))
        shapes.append((segs.size, width))
        order[segs] = col + np.arange(segs.size)
        col += segs.size
    gather = np.where(inside, seg, num_segments)
    as_long = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return _Plan(as_long(gather), bool((~inside).any()), as_long(np.concatenate(members)),
                 tuple(shapes), as_long(order), as_long(counts == 0))


_PLANS: "collections.OrderedDict" = collections.OrderedDict()
_PLAN_CACHE_SIZE = 32


def _plan(idx: torch.Tensor, num_segments: int) -> _Plan:
    """The plan of ``idx`` over ``num_segments`` segments, built once and
    kept while the same tensor object is unchanged (its ``_version``); the
    cache holds the tensor, so its identity cannot be reused."""
    key = (id(idx), idx._version, num_segments)
    hit = _PLANS.get(key)
    if hit is not None and hit[0] is idx:
        _PLANS.move_to_end(key)
        return hit[1]
    plan = _build_plan(idx, num_segments)
    _PLANS[key] = (idx, plan)
    while len(_PLANS) > _PLAN_CACHE_SIZE:
        _PLANS.popitem(last=False)
    return plan


def _blocks(x: torch.Tensor, plan: _Plan, fill: float):
    """The buckets of ``plan`` read from the columns of ``x`` (B, K), each
    (B, rows, width), the sentinel reading ``fill``."""
    ext = torch.cat([x, x.new_full((x.shape[0], 1), fill)], dim=1)
    flat = ext.index_select(1, plan.members)
    out, off = [], 0
    for rows, width in plan.shapes:
        out.append(flat[:, off: off + rows * width].view(x.shape[0], rows, width))
        off += rows * width
    return out


def _assemble(parts, plan: _Plan) -> torch.Tensor:
    """(B, M): the buckets' per-segment results in segment order."""
    return torch.cat(parts, dim=1).index_select(1, plan.order)


def _segment_sum(x: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """(B, M): column c = the sum of the columns of ``x`` in segment c, in a
    fixed order (0 for an empty segment)."""
    return _assemble([blk.sum(dim=2) for blk in _blocks(x, plan, 0.0)], plan)


def _gather_cols(x, plan, fill):
    if plan.has_fill:
        x = torch.cat([x, x.new_full((x.shape[0], 1), fill)], dim=1)
    return x.index_select(1, plan.gather)


class _Take(torch.autograd.Function):
    """``x[:, idx]`` whose backward sums each column's uses in the plan's
    fixed order (the gather's own backward adds with atomics on CUDA)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _gather_cols(x, plan, float("nan"))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _segment_sum(g, ctx.plan), None


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, K) = ``x[:, idx]``, NaN where ``idx`` lies outside [0, x.shape[1])
    (JAX ``take``'s fill); deterministic in value and gradient."""
    plan = _plan(idx, x.shape[1])
    if torch.is_grad_enabled() and x.requires_grad:
        return _Take.apply(x, plan)
    return _gather_cols(x, plan, float("nan"))


def _lse_rows(blk):
    """``_segment_lse``'s reduction of one bucket (B, rows, width)."""
    m = torch.amax(blk, dim=2)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.exp(blk - m_safe[:, :, None]), dim=2)
    alive = s > 0
    return torch.where(alive, torch.log(torch.where(alive, s, torch.ones_like(s))) + m_safe,
                       NEG_INF)


def _lse_forward(scores, plan):
    return _assemble([_lse_rows(b) for b in _blocks(scores, plan, NEG_INF)], plan)


class _SegmentLSE(torch.autograd.Function):
    """Log-semiring sum of arc scores into their destinations; backward
    d out[s] / d scores[e] = exp(scores[e] - out[dst[e]]), 0 where the
    destination is -inf, read with plain gathers."""

    @staticmethod
    def forward(ctx, scores, plan):
        out = _lse_forward(scores, plan)
        ctx.plan = plan
        ctx.save_for_backward(scores, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        scores, out = ctx.saved_tensors
        plan = ctx.plan
        out_e = _gather_cols(out, plan, NEG_INF)
        g_e = _gather_cols(g, plan, 0.0)
        live = torch.isfinite(out_e)
        w = torch.exp(scores - torch.where(live, out_e, torch.zeros_like(out_e)))
        return torch.where(live, w, torch.zeros_like(w)) * g_e, None


def _arc_emissions(i_t: torch.Tensor, ilabel: torch.Tensor) -> torch.Tensor:
    """(B, E) emission score of each arc at one frame: I[t, :, ilabel]."""
    return _take(i_t, ilabel)


def _segment_lse(scores: torch.Tensor, dst: torch.Tensor, num_states: int) -> torch.Tensor:
    """Log-semiring sum of (B, E) arc scores into (B, S) destinations."""
    plan = _plan(dst, num_states)
    if torch.is_grad_enabled() and scores.requires_grad:
        return _SegmentLSE.apply(scores, plan)
    return _lse_forward(scores, plan)


def _check_device(fsa: WFSA, x: torch.Tensor):
    if fsa.src.device != x.device:
        raise ValueError(f"the automaton lies on {fsa.src.device} but the emissions on "
                         f"{x.device}; build it on the emissions' device")


def _arc_scores(fsa: WFSA, alpha, weight, i_t):
    """(B, E) = alpha[:, src] + weight + I[t, :, ilabel], the JAX order."""
    return _take(alpha, fsa.src) + weight[None, :] + _arc_emissions(i_t, fsa.ilabel)


def wfsa_score(fsa: WFSA, inputs: torch.Tensor,
               input_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Log-semiring total path score per batch element, shape (B,).

    score_b = lse over accepting paths (one ARC per frame, L_in[b] arcs):
      start[p_0] + sum_t (weight[e_t] + I[t, b, ilabel[e_t]]) + final[p_L].
    Ragged lengths are masked: alpha freezes past L_in[b], so the final
    combination read after the last frame is the one at t == L_in[b] - 1
    (-inf where L_in lies outside [1, T], as no frame is the last there).
    """
    t_total, num_batches, _ = inputs.shape
    _check_device(fsa, inputs)
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, inputs.device)
    input_lengths = input_lengths.to(inputs.device)
    dt = inputs.dtype
    alpha = fsa.start.to(dt).expand(num_batches, fsa.num_states)
    weight = fsa.weight.to(dt)
    active = torch.arange(t_total, device=inputs.device)[:, None] < input_lengths[None, :]
    for t in range(t_total):
        alpha_new = _segment_lse(_arc_scores(fsa, alpha, weight, inputs[t]), fsa.dst,
                                 fsa.num_states)
        alpha = torch.where(active[t][:, None], alpha_new, alpha)
    score = logsumexp(alpha + fsa.final.to(dt)[None, :], dim=1)
    return torch.where((input_lengths >= 1) & (input_lengths <= t_total), score, NEG_INF)


class WFSAPath(NamedTuple):
    scores: torch.Tensor  # (B,) best-path scores
    states: torch.Tensor  # (T, B) int32 state sequence (dst of each frame), -1 pad
    labels: torch.Tensor  # (T, B) int32 emitted labels, -1 at padding


def _max_rows(blk, ids, num_arcs):
    best = torch.amax(blk, dim=2)
    is_best = (blk >= best[:, :, None]) & torch.isfinite(blk)
    back = torch.where(is_best, ids, num_arcs).amin(dim=2)
    return best, back


def _viterbi_arc_step(fsa: WFSA, alpha: torch.Tensor, i_t: torch.Tensor):
    """One tropical frame: (best (B, S), back (B, S) int32 best incoming arc
    id, the lowest on a tie; E where no incoming arc scores finitely, and
    2^31 - 1 for a state without incoming arcs, JAX's empty ``segment_min``).
    Shared by the one-shot and the streaming decoder."""
    dt = alpha.dtype
    arc = _arc_scores(fsa, alpha, fsa.weight.to(dt), i_t.to(dt))
    plan = _plan(fsa.dst, fsa.num_states)
    ids = plan.members.to(torch.int32)
    bests, backs, off = [], [], 0
    for blk, (rows, width) in zip(_blocks(arc, plan, NEG_INF), plan.shapes):
        best, back = _max_rows(blk, ids[off: off + rows * width].view(rows, width),
                               fsa.num_arcs)
        bests.append(best)
        backs.append(back)
        off += rows * width
    back = torch.where(plan.empty, _INT32_MAX, _assemble(backs, plan))
    return _assemble(bests, plan), back


def _take_fill_int(ext: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``ext[idx]`` with INT32_MIN where ``idx`` lies outside [0, len(ext))."""
    inside = (idx >= 0) & (idx < ext.shape[0])
    return torch.where(inside, ext[idx.clamp(0, ext.shape[0] - 1).long()], _INT32_MIN)


def _wfsa_walk(fsa: WFSA, end_state: torch.Tensor, backs: torch.Tensor,
               inside: torch.Tensor):
    """Arc backtrace from ``end_state`` through ``backs`` (T, B, S);
    ``inside`` (T, B) marks consumed frames.  Returns (states, labels), each
    (T, B) int32 with -1 outside.  Shared one-shot/streaming."""
    t_total = backs.shape[0]
    num_states = backs.shape[2]
    dev = backs.device
    src_ext = torch.cat([fsa.src.to(dev, torch.int32),
                         torch.zeros(1, dtype=torch.int32, device=dev)])
    lab_ext = torch.cat([fsa.ilabel.to(dev, torch.int32),
                         torch.full((1,), -1, dtype=torch.int32, device=dev)])
    state = end_state.to(torch.int32)
    states = torch.empty((t_total, backs.shape[1]), dtype=torch.int32, device=dev)
    labels = torch.empty_like(states)
    for t in range(t_total - 1, -1, -1):
        in_t = inside[t]
        # JAX indexing: a negative state counts from the end, then clamps
        row = torch.where(state < 0, state + num_states, state).clamp(0, num_states - 1)
        arc = torch.gather(backs[t], 1, row.long()[:, None])[:, 0]
        arc = torch.where(in_t, arc, fsa.num_arcs)
        labels[t] = _take_fill_int(lab_ext, arc)
        states[t] = torch.where(in_t, state, -1)
        state = torch.where(in_t, _take_fill_int(src_ext, arc), state)
    return states, labels


def wfsa_viterbi(fsa: WFSA, inputs: torch.Tensor,
                 input_lengths: Optional[torch.Tensor] = None) -> WFSAPath:
    """Tropical-semiring best path through the automaton (decode), with an
    arc backtrace: the WFST-decoder integration point."""
    t_total, num_batches, _ = inputs.shape
    _check_device(fsa, inputs)
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, inputs.device)
    input_lengths = input_lengths.to(inputs.device)
    dt = inputs.dtype
    alpha = fsa.start.to(dt).expand(num_batches, fsa.num_states)
    backs = torch.empty((t_total, num_batches, fsa.num_states), dtype=torch.int32,
                        device=inputs.device)
    for t in range(t_total):
        best, back = _viterbi_arc_step(fsa, alpha, inputs[t])
        active = (t < input_lengths)[:, None]
        alpha = torch.where(active, best, alpha)
        backs[t] = torch.where(active, back, fsa.num_arcs)
    scores, end_state = argmax_first(alpha + fsa.final.to(dt)[None, :], dim=1)
    inside = torch.arange(t_total, device=inputs.device)[:, None] < input_lengths[None, :]
    states, labels = _wfsa_walk(fsa, end_state, backs, inside)
    return WFSAPath(scores, states, labels)


def wfsa_posteriors(fsa: WFSA, inputs: torch.Tensor,
                    input_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-frame emission-label occupation marginals (T, B, N):
    d score / d inputs, soft alignments under the automaton.  The same
    inputs give the same bits on every run."""
    with torch.enable_grad():
        x = inputs.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(wfsa_score(fsa, x, input_lengths).sum(), x)
    return grad
