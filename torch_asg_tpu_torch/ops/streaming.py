"""Streaming (chunked, online) scoring and decoding.

The lattice recursions run left to right, so everything here computes
incrementally: feed emission chunks as they arrive, carry a small state
between chunks, and read exact results at any prefix length.  Each surface
equals its one-shot counterpart on the frames consumed so far:

  * ``streaming_*``          ASG scores (FCC alpha (B, N) + FAC alpha (B, S)
                             carries); ``full - aligned`` is a prefix loss,
                             differentiable with autograd.
                             ``streaming_targets`` precomputes the
                             chunk-invariant target-side rows and the FCC
                             step's exp-transition once per stream.
  * ``streaming_viterbi_*``  best path ((B, N) carry + per-chunk
                             backpointers, backtrace at any prefix).
  * ``streaming_beam_*``     beam-pruned best path ((B, K) carry).
  * ``streaming_nbest_*``    k best distinct paths ((B, N, k) carry).
  * ``streaming_align_*``    forced alignment ((B, S) carry + per-chunk
                             advance bits).
  * ``streaming_wfsa_*``     any acceptor of ``ops/wfsa.py``: scores
                             ((B, num_states) carry) and best path.

Per-element ``chunk_lengths`` mask ragged chunk tails, so batch elements
advance at different rates.  Each ``*_init`` puts its state on ``device``
(the card unless told otherwise); each update runs where its state lies and
raises on a chunk on another device.  Half-precision chunks upcast to
float32: scores accumulate over the whole stream.  An update is a Python
loop over the chunk's frames, a few launches a frame; the JAX package runs
the same steps in ``lax.scan`` (XLA, no Pallas kernel), and so the port
runs plain PyTorch, with no kernel of its own.  The FCC step is a (B, N) x
(N, N) product in full float32 (``semiring.ieee_fp32_products``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fac import _shift_right_s, gather_aligned_emissions, make_aligned
from .fcc import _exp_mats, _lse_mm
from .kernels.common import DEFAULT_DEVICE
from .kernels.viterbi_kernels import argmax_first
from .semiring import NEG_INF, ieee_fp32_products, logaddexp, logsumexp
from .viterbi import (AlignmentResult, NBestResult, ViterbiResult,
                      _labels_from_positions, _maxplus_argmax, _maxplus_topk,
                      _select_row, _select_rows, _topk)
from .wfsa import WFSAPath, _arc_scores, _segment_lse, _viterbi_arc_step, _wfsa_walk
from ..utils.lengths import default_lengths, label_mask, time_mask

_HALF = (torch.bfloat16, torch.float16)


def _accumulation_dtype(dtype):
    """Scores accumulate over the whole stream: half precision would drift,
    so it accumulates in float32, as the one-shot scorers upcast."""
    return torch.float32 if dtype in _HALF else dtype


def _chunk_on(carry: torch.Tensor, chunk: torch.Tensor, chunk_lengths):
    """(the chunk in the carry's dtype, half precision through float32; the
    chunk lengths on its device; valid (T_c, B) bool, frame t < length);
    raises on a chunk on another device."""
    if chunk.device != carry.device:
        raise ValueError(f"the stream's state lies on {carry.device} but the chunk on "
                         f"{chunk.device}")
    t_c, num_batches = chunk.shape[:2]
    if chunk.dtype in _HALF:
        chunk = chunk.float()
    chunk = chunk.to(carry.dtype)
    if chunk_lengths is None:
        chunk_lengths = default_lengths(num_batches, t_c, carry.device)
    chunk_lengths = chunk_lengths.to(carry.device)
    return chunk, chunk_lengths, time_mask(t_c, chunk_lengths)


class StreamingState(NamedTuple):
    """Carry between chunks."""

    alpha_full: torch.Tensor  # (B, N) log-domain FCC alpha
    alpha_aligned: torch.Tensor  # (B, S) log-domain FAC alpha
    frames_seen: torch.Tensor  # (B,) int32


def _frames(num_batches, device):
    return torch.zeros((num_batches,), dtype=torch.int32, device=device)


def streaming_init(num_batches: int, num_labels: int, s_total: int,
                   dtype=torch.float32, *, device=DEFAULT_DEVICE) -> StreamingState:
    """Fresh state: no frames consumed yet."""
    dtype = _accumulation_dtype(dtype)
    return StreamingState(
        torch.full((num_batches, num_labels), NEG_INF, dtype=dtype, device=device),
        torch.full((num_batches, s_total), NEG_INF, dtype=dtype, device=device),
        _frames(num_batches, device))


class StreamTargets(NamedTuple):
    """Chunk-invariant target-side rows, precomputed once per stream
    (``streaming_targets``); an update given them pays only the per-chunk
    emission gather."""

    tgt: torch.Tensor  # (B, S) clipped targets
    onehot: Optional[torch.Tensor]  # None: the port gathers with indices
    self_trans: torch.Tensor  # (B, S)
    next_trans: torch.Tensor  # (B, S)
    smask: torch.Tensor  # (B, S) bool, s < target_lengths[b]
    e_t: Optional[torch.Tensor] = None  # (N, N) exp(T - c).T for the FCC step
    c: Optional[torch.Tensor] = None  # scalar offset of e_t


def streaming_targets(transition: torch.Tensor, targets: torch.Tensor, num_labels: int,
                      target_lengths: Optional[torch.Tensor] = None,
                      dtype=torch.float32) -> StreamTargets:
    """Precompute the fixed target-side lattice rows (and the FCC step's
    exp-transition) of a stream, on the transition's device.  The
    precompute dtype is promoted with the transition's own, so a float64
    stream keeps parity with the one-shot scorer even when the caller
    forgets ``dtype``."""
    num_batches, s_total = targets.shape
    dev = transition.device
    dtype = torch.promote_types(transition.dtype, _accumulation_dtype(dtype))
    if target_lengths is None:
        target_lengths = default_lengths(num_batches, s_total, dev)
    target_lengths = target_lengths.to(dev)
    dummy = torch.zeros((1, num_batches, num_labels), dtype=dtype, device=dev)
    lat = make_aligned(transition, dummy, targets.to(dev),
                       torch.ones((num_batches,), dtype=torch.int32, device=dev),
                       target_lengths)
    e, c = _exp_mats(transition, dtype)
    return StreamTargets(lat.targets, None, lat.self_trans, lat.next_trans,
                         label_mask(s_total, target_lengths), e.T, c)


def _check_precompute(precomputed_dtype, dtype):
    if torch.promote_types(precomputed_dtype, dtype) != precomputed_dtype:
        raise ValueError(
            f"stream_targets was precomputed at {precomputed_dtype} but the streaming "
            f"state accumulates at {dtype}; rebuild with streaming_targets(..., "
            f"dtype={dtype}), or the rounded lattice rows lose parity with the "
            f"one-shot scorer")


def _aligned_chunk(transition, chunk, targets, chunk_lengths, target_lengths,
                   stream_targets):
    """(aligned chunk emissions (T_c, B, S), self_trans, next_trans, tgt):
    the target-side rows from ``stream_targets`` or from ``targets``."""
    t_c, num_batches, _ = chunk.shape
    dev = chunk.device
    if stream_targets is not None:
        if targets is not None or target_lengths is not None:
            raise ValueError(
                "pass either stream_targets OR targets/target_lengths, not both "
                "(stream_targets already holds them; a conflicting pair would be "
                "silently ignored)")
        _check_precompute(stream_targets.self_trans.dtype, chunk.dtype)
        # a precompute at higher precision is cast down: the state's dtype rules
        dt = chunk.dtype
        aligned = gather_aligned_emissions(chunk, stream_targets.tgt.to(dev),
                                           time_mask(t_c, chunk_lengths),
                                           stream_targets.smask.to(dev))
        return (aligned.to(dt), stream_targets.self_trans.to(dev, dt),
                stream_targets.next_trans.to(dev, dt), stream_targets.tgt)
    if targets is None:
        raise ValueError("pass either targets or stream_targets")
    if target_lengths is None:
        target_lengths = default_lengths(num_batches, targets.shape[1], dev)
    lat = make_aligned(transition, chunk, targets.to(dev), chunk_lengths,
                       target_lengths.to(dev))
    return lat.inputs, lat.self_trans, lat.next_trans, lat.targets


def streaming_update(transition: torch.Tensor, state: StreamingState, chunk: torch.Tensor,
                     targets: Optional[torch.Tensor] = None,
                     chunk_lengths: Optional[torch.Tensor] = None,
                     target_lengths: Optional[torch.Tensor] = None,
                     stream_targets: Optional[StreamTargets] = None) -> StreamingState:
    """Consume a (T_c, B, N) emission chunk.

    Frames with t >= chunk_lengths[b] are ignored, so batch elements may
    advance at different rates across calls.  targets/target_lengths must be
    the same on every call (the aligned lattice is fixed); a precomputed
    ``stream_targets`` replaces them.
    """
    chunk, chunk_lengths, valids = _chunk_on(state.alpha_full, chunk, chunk_lengths)
    dt, dev = chunk.dtype, chunk.device
    transition = transition.to(dev, dt)
    aligned, self_trans, next_trans, _ = _aligned_chunk(
        transition, chunk, targets, chunk_lengths, target_lengths, stream_targets)
    if stream_targets is not None and stream_targets.e_t is not None:
        _check_precompute(stream_targets.e_t.dtype, dt)
        e_t, c = stream_targets.e_t.to(dev, dt), stream_targets.c.to(dev, dt)
    else:
        e, c = _exp_mats(transition, dt)
        e_t = e.T
    af, aa, seen = state
    slot0 = torch.arange(aligned.shape[2], device=dev)[None, :] == 0
    with ieee_fp32_products():
        for t in range(chunk.shape[0]):
            valid = valids[t][:, None]
            first = (seen == 0)[:, None] & valid
            i_t, ai_t = chunk[t], aligned[t]
            # FCC: alpha_t = I_t + lse_j(T + alpha_{t-1}); the first frame is I_t
            af_new = torch.where(first, i_t, i_t + _lse_mm(af, e_t, c))
            af = torch.where(valid, af_new, af)
            # FAC: the 2-way band step, seeded at s = 0 on the first frame.
            # semiring.logaddexp: dead band rows are -inf on both sides, and
            # the prefix loss must keep finite gradients there
            hori = aa + self_trans
            diag = _shift_right_s(aa + next_trans)
            aa_new = torch.where(first, torch.where(slot0, ai_t, NEG_INF),
                                 ai_t + logaddexp(hori, diag))
            aa = torch.where(valid, aa_new, aa)
            seen = seen + valids[t].to(torch.int32)
    return StreamingState(af, aa, seen)


def streaming_scores(state: StreamingState,
                     target_lengths: Optional[torch.Tensor] = None) -> tuple:
    """(full, aligned) scores of everything consumed so far, shape (B,).

    ``full`` equals ``fcc_score`` at input_lengths == frames_seen;
    ``aligned`` equals ``fac_score`` (the alpha entry at s = L_out - 1; -inf
    while the prefix cannot yet cover the target).
    """
    full = logsumexp(state.alpha_full, dim=1)
    if target_lengths is None:
        return full, state.alpha_aligned[:, -1]
    s_total = state.alpha_aligned.shape[1]
    dev = state.alpha_aligned.device
    pick = (torch.arange(s_total, device=dev)[None, :]
            == (target_lengths.to(dev) - 1)[:, None])
    aligned = torch.where(pick, state.alpha_aligned, NEG_INF).amax(dim=1)
    return full, aligned


# --- Viterbi (tropical semiring) ----------------------------------------------
#
# The carry is the (B, N) best-path row; each update also returns the chunk's
# backpointers and per-frame validity, which the caller concatenates and
# hands to ``streaming_viterbi_backtrace`` for the best path so far.  The
# step is ``_maxplus_argmax``, the one-shot decoder's, so ties break alike.


class StreamingViterbiState(NamedTuple):
    delta: torch.Tensor  # (B, N) best-path score ending at each label
    frames_seen: torch.Tensor  # (B,) int32


def streaming_viterbi_init(num_batches: int, num_labels: int, dtype=torch.float32, *,
                           device=DEFAULT_DEVICE) -> StreamingViterbiState:
    dtype = _accumulation_dtype(dtype)
    return StreamingViterbiState(
        torch.full((num_batches, num_labels), NEG_INF, dtype=dtype, device=device),
        _frames(num_batches, device))


def _ident(num_batches, width, device):
    return torch.arange(width, dtype=torch.int32, device=device).expand(num_batches, width)


def streaming_viterbi_update(transition: torch.Tensor, state: StreamingViterbiState,
                             chunk: torch.Tensor,
                             chunk_lengths: Optional[torch.Tensor] = None) -> tuple:
    """Consume a (T_c, B, N) emission chunk.

    Returns ``(state, (backptr, valid))``: backptr (T_c, B, N) int32 maps the
    label at a frame to the label at the element's previous consumed frame
    (identity at first and invalid frames, so concatenated blocks compose
    under ragged ``chunk_lengths``); valid (T_c, B) bool.
    """
    chunk, _, valids = _chunk_on(state.delta, chunk, chunk_lengths)
    t_c, num_batches, num_labels = chunk.shape
    transition = transition.to(chunk.device, chunk.dtype)
    ident = _ident(num_batches, num_labels, chunk.device)
    d, seen = state
    backptr = torch.empty((t_c, num_batches, num_labels), dtype=torch.int32,
                          device=chunk.device)
    for t in range(t_c):
        valid = valids[t][:, None]
        first = (seen == 0)[:, None] & valid
        best, bp = _maxplus_argmax(transition, d)
        d = torch.where(valid, torch.where(first, chunk[t], chunk[t] + best), d)
        backptr[t] = torch.where(valid & ~first, bp.to(torch.int32), ident)
        seen = seen + valids[t].to(torch.int32)
    return StreamingViterbiState(d, seen), (backptr, valids)


def streaming_viterbi_backtrace(state: StreamingViterbiState, backptr: torch.Tensor,
                                valid: torch.Tensor) -> ViterbiResult:
    """Best path over all frames consumed so far.

    backptr (T, B, N) / valid (T, B): ``streaming_viterbi_update``'s outputs
    concatenated along time.  Emits -1 at frames an element did not consume;
    an element with no frames yet scores -inf with an all -1 path.
    """
    scores, lab = argmax_first(state.delta, dim=1)
    lab = lab.to(torch.int32)
    emits = torch.empty(valid.shape, dtype=torch.int32, device=valid.device)
    for t in range(valid.shape[0] - 1, -1, -1):
        emits[t] = torch.where(valid[t], lab, -1)
        lab = torch.where(valid[t], _select_row(backptr[t], lab.clamp(min=0)), lab)
    return ViterbiResult(scores, emits)


# --- beam-pruned decoding -----------------------------------------------------
#
# The online form of ``beam_decode``: the carry is the (B, K) pruned beam
# (scores and label ids), so a step is O(B N K).  Each update returns the
# beam labels and slot backpointers per frame (identity at first and invalid
# frames); the candidate order and ``_topk`` are the one-shot decoder's, so
# ties break alike.


class StreamingBeamState(NamedTuple):
    delta: torch.Tensor  # (B, K) pruned best-path scores, descending
    labels: torch.Tensor  # (B, K) int32 label ids of the beam slots
    frames_seen: torch.Tensor  # (B,) int32


def streaming_beam_init(num_batches: int, beam_size: int, dtype=torch.float32, *,
                        device=DEFAULT_DEVICE) -> StreamingBeamState:
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    dtype = _accumulation_dtype(dtype)
    return StreamingBeamState(
        torch.full((num_batches, beam_size), NEG_INF, dtype=dtype, device=device),
        torch.zeros((num_batches, beam_size), dtype=torch.int32, device=device),
        _frames(num_batches, device))


def streaming_beam_update(transition: torch.Tensor, state: StreamingBeamState,
                          chunk: torch.Tensor,
                          chunk_lengths: Optional[torch.Tensor] = None) -> tuple:
    """Consume a (T_c, B, N) emission chunk.

    Returns ``(state, (labels, backptr, valid))``: labels/backptr (T_c, B, K)
    int32, the frame's beam labels and each slot's slot at the element's
    previous consumed frame; valid (T_c, B) bool.  A beam wider than N
    carries -inf in its tail slots, which never win.
    """
    chunk, _, valids = _chunk_on(state.delta, chunk, chunk_lengths)
    t_c, num_batches, num_labels = chunk.shape
    k = state.delta.shape[1]
    k_eff = min(k, num_labels)
    dev = chunk.device
    trans_t = transition.to(dev, chunk.dtype).T.contiguous()  # (from, to)
    ident = _ident(num_batches, k, dev)
    d, lab, seen = state
    labs = torch.empty((t_c, num_batches, k), dtype=torch.int32, device=dev)
    bps = torch.empty_like(labs)
    for t in range(t_c):
        valid = valids[t][:, None]
        first = (seen == 0)[:, None] & valid
        cand = trans_t[lab.long()] + d[:, :, None]  # (B, K, N)
        best = cand.amax(dim=1)
        from_slot = torch.argmax(cand, dim=1).to(torch.int32)  # first maximal slot
        # merging the seed before the top-k keeps one top-k a frame, with the
        # same values reaching ``_topk`` as a separate seed top-k
        d_new, lab_new = _topk(torch.where(first, chunk[t], chunk[t] + best), k_eff)
        if k_eff < k:
            pad = (0, k - k_eff)
            d_new = torch.nn.functional.pad(d_new, pad, value=NEG_INF)
            lab_new = torch.nn.functional.pad(lab_new, pad)
        bps[t] = torch.where(valid & ~first, _select_rows(from_slot, lab_new), ident)
        d = torch.where(valid, d_new, d)
        lab = torch.where(valid, lab_new, lab)
        labs[t] = lab
        seen = seen + valids[t].to(torch.int32)
    return StreamingBeamState(d, lab, seen), (labs, bps, valids)


def _streaming_beam_backtrace_from(labels, backptr, valid, start):
    """(T, B, R) paths, path r starting the backtrace at beam slot
    ``start[b, r]``."""
    slot = start
    emits = torch.empty(valid.shape + start.shape[1:], dtype=torch.int32,
                        device=valid.device)
    for t in range(valid.shape[0] - 1, -1, -1):
        v_t = valid[t][:, None]
        emits[t] = torch.where(v_t, _select_rows(labels[t], slot), -1)
        slot = torch.where(v_t, _select_rows(backptr[t], slot), slot)
    return emits


def streaming_beam_backtrace(state: StreamingBeamState, labels: torch.Tensor,
                             backptr: torch.Tensor, valid: torch.Tensor) -> ViterbiResult:
    """Best surviving path over all frames consumed so far.

    labels/backptr (T, B, K) / valid (T, B): ``streaming_beam_update``'s
    outputs concatenated along time.  Emits -1 at frames an element did not
    consume; an element with no frames yet scores -inf with an all -1 path.
    """
    start = torch.zeros((state.delta.shape[0], 1), dtype=torch.int32,
                        device=state.delta.device)
    paths = _streaming_beam_backtrace_from(labels, backptr, valid, start)[:, :, 0]
    return ViterbiResult(state.delta[:, 0], paths)


def streaming_beam_nbest_backtrace(state: StreamingBeamState, labels: torch.Tensor,
                                   backptr: torch.Tensor, valid: torch.Tensor,
                                   n: int) -> NBestResult:
    """The n best final-label hypotheses of the consumed prefix: the
    streaming form of ``beam_nbest`` (distinct final labels, exact scores,
    rank 0 == ``streaming_beam_backtrace``); requires n <= beam_size.
    Returns scores (B, n) descending and paths (T, B, n)."""
    num_batches, k = state.delta.shape
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if n > k:
        raise ValueError(f"n={n} exceeds the state's beam_size={k}")
    start = torch.arange(n, dtype=torch.int32, device=state.delta.device).repeat(
        num_batches, 1)
    return NBestResult(state.delta[:, :n],
                       _streaming_beam_backtrace_from(labels, backptr, valid, start))


# --- n-best -------------------------------------------------------------------
#
# The (label, rank) lattice of ``viterbi_nbest``: carry (B, N, k), emit flat
# (label * k + rank) backpointers (T_c, B, N, k) per chunk; ``_maxplus_topk``
# is the one-shot decoder's, so ties break alike.


class StreamingNBestState(NamedTuple):
    delta: torch.Tensor  # (B, N, k)
    frames_seen: torch.Tensor  # (B,) int32


def streaming_nbest_init(num_batches: int, num_labels: int, k: int, dtype=torch.float32, *,
                         device=DEFAULT_DEVICE) -> StreamingNBestState:
    dtype = _accumulation_dtype(dtype)
    return StreamingNBestState(
        torch.full((num_batches, num_labels, k), NEG_INF, dtype=dtype, device=device),
        _frames(num_batches, device))


def streaming_nbest_update(transition: torch.Tensor, state: StreamingNBestState,
                           chunk: torch.Tensor,
                           chunk_lengths: Optional[torch.Tensor] = None) -> tuple:
    """Consume a (T_c, B, N) chunk; returns (state, (backptr, valid)) with
    backptr (T_c, B, N, k) int32 flat (label * k + rank) indices."""
    chunk, _, valids = _chunk_on(state.delta, chunk, chunk_lengths)
    t_c, num_batches, num_labels = chunk.shape
    k = state.delta.shape[2]
    dev = chunk.device
    transition = transition.to(dev, chunk.dtype)
    ident = torch.arange(num_labels * k, dtype=torch.int32, device=dev).view(
        1, num_labels, k).expand(num_batches, num_labels, k)
    rank0 = torch.arange(k, device=dev)[None, None, :] == 0
    d, seen = state
    backptr = torch.empty((t_c, num_batches, num_labels, k), dtype=torch.int32, device=dev)
    for t in range(t_c):
        valid = valids[t][:, None, None]
        first = (seen == 0)[:, None, None] & valid
        vals, bp = _maxplus_topk(transition, d, k)
        i_t = chunk[t][:, :, None]
        d_new = torch.where(first, torch.where(rank0, i_t, NEG_INF), i_t + vals)
        d = torch.where(valid, d_new, d)
        backptr[t] = torch.where(valid & ~first, bp, ident)
        seen = seen + valids[t].to(torch.int32)
    return StreamingNBestState(d, seen), (backptr, valids)


def streaming_nbest_backtrace(state: StreamingNBestState, backptr: torch.Tensor,
                              valid: torch.Tensor) -> NBestResult:
    """k best distinct paths over all frames consumed so far; -1 at frames an
    element did not consume (``viterbi_nbest``'s conventions on the
    concatenated prefix)."""
    num_batches, num_labels, k = state.delta.shape
    scores, flat = _topk(state.delta.reshape(num_batches, num_labels * k), k)
    flats = torch.empty(valid.shape + (k,), dtype=torch.int32, device=valid.device)
    for t in range(valid.shape[0] - 1, -1, -1):
        v_t = valid[t][:, None]
        flats[t] = torch.where(v_t, flat, -1)
        prev = _select_rows(backptr[t].reshape(num_batches, num_labels * k),
                            flat.clamp(min=0))
        flat = torch.where(v_t, prev, flat)
    paths = torch.where(flats >= 0, torch.div(flats, k, rounding_mode="floor"), -1)
    return NBestResult(scores, paths.to(torch.int32))


# --- forced alignment ---------------------------------------------------------
#
# The aligned (FAC) lattice in the tropical semiring: carry the (B, S)
# best-segmentation scores, emit one advance bit per (b, s) a frame (did
# the best path into slot s come from slot s - 1?), backtrace the prefix's
# segmentation at any point.  A stay/advance tie stays, as in
# ``viterbi_align``.


class StreamingAlignState(NamedTuple):
    delta: torch.Tensor  # (B, S) best-alignment score ending at each slot
    frames_seen: torch.Tensor  # (B,) int32


def streaming_align_init(num_batches: int, s_total: int, dtype=torch.float32, *,
                         device=DEFAULT_DEVICE) -> StreamingAlignState:
    dtype = _accumulation_dtype(dtype)
    return StreamingAlignState(
        torch.full((num_batches, s_total), NEG_INF, dtype=dtype, device=device),
        _frames(num_batches, device))


def streaming_align_update(transition: torch.Tensor, state: StreamingAlignState,
                           chunk: torch.Tensor, targets: Optional[torch.Tensor] = None,
                           chunk_lengths: Optional[torch.Tensor] = None,
                           target_lengths: Optional[torch.Tensor] = None,
                           stream_targets: Optional[StreamTargets] = None) -> tuple:
    """Consume a (T_c, B, N) emission chunk.

    Returns ``(state, (adv, valid))``: adv (T_c, B, S) int32 advance bits (1
    iff the best path into slot s advanced from slot s - 1; 0 at first and
    invalid frames) and valid (T_c, B) bool.  targets / target_lengths (or
    ``stream_targets``) must be the same on every call.
    """
    chunk, chunk_lengths, valids = _chunk_on(state.delta, chunk, chunk_lengths)
    transition = transition.to(chunk.device, chunk.dtype)
    aligned, self_trans, next_trans, _ = _aligned_chunk(
        transition, chunk, targets, chunk_lengths, target_lengths, stream_targets)
    t_c, num_batches, s_total = aligned.shape
    d, seen = state
    adv = torch.empty((t_c, num_batches, s_total), dtype=torch.int32, device=chunk.device)
    slot0 = torch.arange(s_total, device=chunk.device)[None, :] == 0
    for t in range(t_c):
        valid = valids[t][:, None]
        first = (seen == 0)[:, None] & valid
        stay = d + self_trans
        move = _shift_right_s(d + next_trans)
        d_new = torch.where(first, torch.where(slot0, aligned[t], NEG_INF),
                            aligned[t] + torch.maximum(stay, move))
        d = torch.where(valid, d_new, d)
        adv[t] = (valid & ~first & (move > stay)).to(torch.int32)
        seen = seen + valids[t].to(torch.int32)
    return StreamingAlignState(d, seen), (adv, valids)


def streaming_align_backtrace(state: StreamingAlignState, adv: torch.Tensor,
                              valid: torch.Tensor, targets: Optional[torch.Tensor] = None,
                              target_lengths: Optional[torch.Tensor] = None,
                              stream_targets: Optional[StreamTargets] = None
                              ) -> AlignmentResult:
    """Best monotonic alignment over all frames consumed so far.

    adv (T, B, S) / valid (T, B): ``streaming_align_update``'s outputs
    concatenated along time.  Emits -1 at frames an element did not consume;
    an element with no frames yet, or with a target length outside [1, S],
    scores -inf (as ``viterbi_align``).  ``targets`` or ``stream_targets``
    supplies the emitted labels.
    """
    num_batches, s_total = state.delta.shape
    dev = state.delta.device
    if stream_targets is not None:
        if targets is not None:
            raise ValueError("pass either stream_targets OR targets, not both")
        tgt = stream_targets.tgt
        if target_lengths is None:
            # the precompute holds the ragged lengths in smask; full S here
            # would anchor the backtrace at the wrong final slot
            target_lengths = stream_targets.smask.sum(dim=1).to(torch.int32)
    else:
        if targets is None:
            raise ValueError("pass either targets or stream_targets")
        tgt = targets
    if target_lengths is None:
        target_lengths = default_lengths(num_batches, s_total, dev)
    target_lengths = target_lengths.to(dev)
    end_s = (target_lengths - 1).to(torch.int32)
    alignable = (state.frames_seen > 0) & (target_lengths >= 1) & (target_lengths <= s_total)
    scores = torch.where(alignable, _select_row(state.delta, end_s), NEG_INF)
    pos = end_s
    positions = torch.empty(valid.shape, dtype=torch.int32, device=dev)
    for t in range(valid.shape[0] - 1, -1, -1):
        positions[t] = torch.where(valid[t], pos, -1)
        took = _select_row(adv[t], pos.clamp(min=0))
        pos = torch.where(valid[t], pos.clamp(min=0) - took, pos)
    return AlignmentResult(scores, positions,
                           _labels_from_positions(positions, tgt.to(dev)))


# --- generic WFSA -------------------------------------------------------------
#
# The acceptor recursion (ops/wfsa.py) is also one arc a frame, so it streams
# with a (B, num_states) carry that starts at the automaton's start weights
# (no first-frame case).  At zero consumed frames the readout is the
# empty-path acceptance score.


class StreamingWFSAState(NamedTuple):
    alpha: torch.Tensor  # (B, num_states) log-domain forward weights
    frames_seen: torch.Tensor  # (B,) int32


def _start_rows(fsa, num_batches, dtype, device):
    return fsa.start.to(device, _accumulation_dtype(dtype)).expand(
        num_batches, fsa.num_states).clone()


def streaming_wfsa_init(fsa, num_batches: int, dtype=torch.float32, *,
                        device=DEFAULT_DEVICE) -> StreamingWFSAState:
    return StreamingWFSAState(_start_rows(fsa, num_batches, dtype, device),
                              _frames(num_batches, device))


def streaming_wfsa_update(fsa, state: StreamingWFSAState, chunk: torch.Tensor,
                          chunk_lengths: Optional[torch.Tensor] = None
                          ) -> StreamingWFSAState:
    """Consume a (T_c, B, N) emission chunk through the acceptor (which must
    lie on the state's device)."""
    chunk, _, valids = _chunk_on(state.alpha, chunk, chunk_lengths)
    weight = fsa.weight.to(chunk.dtype)
    alpha, seen = state
    for t in range(chunk.shape[0]):
        alpha_new = _segment_lse(_arc_scores(fsa, alpha, weight, chunk[t]), fsa.dst,
                                 fsa.num_states)
        alpha = torch.where(valids[t][:, None], alpha_new, alpha)
        seen = seen + valids[t].to(torch.int32)
    return StreamingWFSAState(alpha, seen)


def streaming_wfsa_scores(fsa, state: StreamingWFSAState) -> torch.Tensor:
    """(B,) acceptance score of everything consumed so far; equals the
    one-shot ``wfsa_score`` at input_lengths == frames_seen >= 1.  At zero
    consumed frames it is the empty-path acceptance lse(start + final),
    where the one-shot scorer gives -inf."""
    return logsumexp(state.alpha + fsa.final.to(state.alpha.dtype)[None, :], dim=1)


class StreamingWFSAViterbiState(NamedTuple):
    delta: torch.Tensor  # (B, num_states) best-path score into each state
    frames_seen: torch.Tensor  # (B,) int32


def streaming_wfsa_viterbi_init(fsa, num_batches: int, dtype=torch.float32, *,
                                device=DEFAULT_DEVICE) -> StreamingWFSAViterbiState:
    return StreamingWFSAViterbiState(_start_rows(fsa, num_batches, dtype, device),
                                     _frames(num_batches, device))


def streaming_wfsa_viterbi_update(fsa, state: StreamingWFSAViterbiState,
                                  chunk: torch.Tensor,
                                  chunk_lengths: Optional[torch.Tensor] = None) -> tuple:
    """Consume a (T_c, B, N) emission chunk; tropical semiring.

    Returns ``(state, (backs, valid))``: backs (T_c, B, num_states) int32
    best-incoming-arc ids (``fsa.num_arcs`` at invalid frames and where no
    arc scores finitely), valid (T_c, B) bool; concatenated blocks compose
    under ``streaming_wfsa_viterbi_backtrace``, ragged rates included.
    """
    chunk, _, valids = _chunk_on(state.delta, chunk, chunk_lengths)
    t_c, num_batches, _ = chunk.shape
    d, seen = state
    backs = torch.empty((t_c, num_batches, fsa.num_states), dtype=torch.int32,
                        device=chunk.device)
    for t in range(t_c):
        best, back = _viterbi_arc_step(fsa, d, chunk[t])
        valid = valids[t][:, None]
        d = torch.where(valid, best, d)
        backs[t] = torch.where(valid, back, fsa.num_arcs)
        seen = seen + valids[t].to(torch.int32)
    return StreamingWFSAViterbiState(d, seen), (backs, valids)


def streaming_wfsa_viterbi_backtrace(fsa, state: StreamingWFSAViterbiState,
                                     backs: torch.Tensor, valid: torch.Tensor) -> WFSAPath:
    """Best accepted path over all frames consumed so far.

    backs (T, B, num_states) / valid (T, B): the update's outputs
    concatenated along time.  Equals the one-shot ``wfsa_viterbi`` on the
    consumed prefix (the same arc step and walk, lowest arc id on ties);
    frames an element did not consume emit -1.  An element with zero
    consumed frames scores the best empty-path acceptance max(start + final)
    with an all -1 path.
    """
    final_tot = state.delta + fsa.final.to(state.delta.dtype)[None, :]
    scores, end_state = argmax_first(final_tot, dim=1)
    states, labels = _wfsa_walk(fsa, end_state, backs, valid)
    return WFSAPath(scores, states, labels)
