"""Viterbi decoding and forced alignment in the tropical (max) semiring.

``viterbi_decode`` finds the best unconstrained label path through the
fully-connected lattice: the ASG recursion with (max, argmax) in place of
logsumexp, plus a backtrace.  ``viterbi_align`` finds the best monotonic
alignment of the target sequence to the frames (the segmentation that gives
ASG its name), and ``alignment_segments`` turns it into frame spans per
target slot.  Ragged lengths are masked as in the loss; paths and positions
hold -1 at padding frames.

Decoding tiers (``impl``):
  * ``'pallas'``: the hand-written kernel pair (``ops/kernels/viterbi_kernels``:
    the max-plus forward K10 and the backtrace K11) on CUDA tensors, their
    plain versions on CPU tensors; takes up to ``VITERBI_KERNEL_MAX_LABELS``
    labels.
  * ``'xla'``: plain PyTorch, a loop over frames with the (B, N, N)
    candidate step, chunked over destination labels past
    ``_CHUNK_MIN_LABELS``.
  * ``'auto'``: ``'pallas'`` for CUDA tensors within the kernel's label cap,
    ``'xla'`` otherwise.
All tiers break exact ties toward the lowest source label, so their paths
are bit-identical.

Alignment tiers (``impl``): ``'pallas'``, the kernel pair K12 + K13 on CUDA
tensors (their plain versions on CPU ones), up to ``ALIGN_KERNEL_MAX_WIDTH``
target slots; ``'xla'``, the kernels' plain versions (PyTorch loops over the
frames, any width); ``'auto'``, ``'pallas'`` for CUDA tensors within the cap,
``'xla'`` otherwise.  Both break a stay/advance tie toward staying, so their
positions are bit-identical.

``viterbi_nbest`` (the k best distinct paths, for LM rescoring),
``beam_decode`` (beam-pruned decoding for wordpiece-scale vocabularies,
O(T B N K) instead of O(T B N^2)) and ``beam_nbest`` (the n best final-label
hypotheses of one beam pass) are plain PyTorch loops over the frames, on
any device; the JAX package runs them in XLA, with no Pallas kernel.  They
use only additions, maxima and selections, and break every tie toward the
lowest index (``_topk``), so their bits do not depend on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fac import make_aligned
from .semiring import NEG_INF
from .kernels.viterbi_kernels import (ALIGN_KERNEL_MAX_WIDTH,
                                      VITERBI_KERNEL_MAX_LABELS, _select_row,
                                      _select_rows, align_backtrace_pallas,
                                      align_backtrace_plain, align_forward_pallas,
                                      align_forward_plain, argmax_first,
                                      viterbi_backtrace_pallas,
                                      viterbi_forward_pallas)
from ..utils.lengths import default_lengths, mask_emissions
from ..utils.profiling import span

# Beyond this many labels, the per-step (B, N, N) max-plus tensor is built in
# destination chunks to bound live memory.
_CHUNK_MIN_LABELS = 1024
_CHUNK_SIZE = 512


class ViterbiResult(NamedTuple):
    scores: torch.Tensor  # (B,) best-path scores
    paths: torch.Tensor  # (T, B) int32 labels, -1 at padding frames


class AlignmentResult(NamedTuple):
    scores: torch.Tensor  # (B,) best-alignment scores
    positions: torch.Tensor  # (T, B) int32 target positions s_t, -1 at padding
    labels: torch.Tensor  # (T, B) int32 aligned labels targets[b, s_t], -1 at padding


class SegmentsResult(NamedTuple):
    starts: torch.Tensor  # (B, S) int32 first frame of slot s, -1 if unused
    ends: torch.Tensor  # (B, S) int32 last frame (inclusive), -1 if unused


def _decode_inputs(transition, inputs, input_lengths):
    """The decoders' common preparation: full lengths when none are given,
    lengths and transition on the emissions' device, and half-precision
    emissions in float32 (path scores accumulate over T steps, too long for
    half-precision mantissas)."""
    t_total, num_batches, _ = inputs.shape
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, inputs.device)
    input_lengths = input_lengths.to(inputs.device)
    if inputs.dtype in (torch.bfloat16, torch.float16):
        inputs = inputs.float()
    return transition.to(device=inputs.device, dtype=inputs.dtype), inputs, input_lengths


def _maxplus_argmax(transition, d_prev):
    """(best, argmax) over j of ``transition[i, j] + d_prev[b, j]``; ties go
    to the lowest j."""
    num_labels = transition.shape[0]
    if num_labels <= _CHUNK_MIN_LABELS:
        return argmax_first(transition[None, :, :] + d_prev[:, None, :], dim=2)
    bests, args = [], []
    for rows in torch.split(transition, _CHUNK_SIZE, dim=0):
        b, a = argmax_first(rows[None, :, :] + d_prev[:, None, :], dim=2)
        bests.append(b)
        args.append(a)
    return torch.cat(bests, dim=1), torch.cat(args, dim=1)


def _backtrace_1best(d_end, backptr, input_lengths, t_total) -> ViterbiResult:
    """Shared backtrace: d_end (B, N) end rows, backptr T-1 rows of (B, N)
    where backptr[t-1] maps the label at frame t to the label at frame t-1."""
    scores, final_labels = argmax_first(d_end, dim=1)
    final_labels = final_labels.to(torch.int32)
    pad = torch.full_like(final_labels, -1)
    lab = torch.where(input_lengths - 1 == t_total - 1, final_labels, pad)
    paths = [lab]
    for t in range(t_total - 2, -1, -1):
        src = lab.clamp(min=0).long()[:, None]
        prev = torch.gather(backptr[t], 1, src)[:, 0].to(torch.int32)
        lab = torch.where(
            input_lengths - 1 == t,
            final_labels,
            torch.where(t < input_lengths - 1, prev, pad),
        )
        paths.append(lab)
    return ViterbiResult(scores, torch.stack(paths[::-1]))


def viterbi_decode(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    impl: str = "auto",
) -> ViterbiResult:
    """Best label path per batch element.

    transition: (N, N), [i, j] = score of j -> i; inputs: (T, B, N).
    impl: 'pallas' | 'xla' | 'auto' (see the module docstring).  Under a
    profiler the call is the span ``asg.decode``.
    """
    with span("asg.decode"):
        t_total, num_batches, num_labels = inputs.shape
        transition, inputs, input_lengths = _decode_inputs(transition, inputs, input_lengths)

        if impl == "auto":
            impl = (
                "pallas"
                if inputs.is_cuda and num_labels <= VITERBI_KERNEL_MAX_LABELS
                else "xla"
            )
        if impl == "pallas":
            if num_labels > VITERBI_KERNEL_MAX_LABELS:
                raise ValueError(
                    f"impl='pallas' runs one thread per label in one block and "
                    f"supports num_labels <= {VITERBI_KERNEL_MAX_LABELS}; got "
                    f"{num_labels}.  Use impl='xla' (chunked candidate tensor) "
                    f"for wordpiece-scale vocabularies."
                )
            d_end, bp = viterbi_forward_pallas(transition, inputs.contiguous(),
                                               input_lengths)
            scores, final_labels = argmax_first(d_end, dim=1)
            paths = viterbi_backtrace_pallas(final_labels, bp, input_lengths)
            return ViterbiResult(scores, paths)
        if impl != "xla":
            raise ValueError(
                f"unknown impl {impl!r}; expected 'auto', 'pallas', or 'xla'"
            )
        inputs_m = mask_emissions(inputs, input_lengths)
        d = inputs_m[0]
        d_end = d
        backptr = []
        for t in range(1, t_total):
            best, bp = _maxplus_argmax(transition, d)
            d = inputs_m[t] + best
            d_end = torch.where((input_lengths - 1 == t)[:, None], d, d_end)
            backptr.append(bp)
        return _backtrace_1best(d_end, backptr, input_lengths, t_total)


def alignment_segments(alignment: AlignmentResult, s_total: int) -> SegmentsResult:
    """Frame spans per target slot from a ``viterbi_align`` result.

    Slot s of element b occupies frames ``starts[b, s] .. ends[b, s]``
    (inclusive; multiply by the frontend's frame stride for seconds).
    ``s_total`` is the padded target width S.  Slots past
    ``target_lengths[b]`` are (-1, -1).  Spans partition each utterance:
    starts[b, 0] == 0 and consecutive spans abut.
    """
    positions = alignment.positions  # (T, B) int32, -1 at padding
    t_total = positions.shape[0]
    dev = positions.device
    slot = torch.arange(s_total, dtype=torch.int32, device=dev)[None, None, :]
    hit = positions[:, :, None] == slot  # (T, B, S)
    ts = torch.arange(t_total, dtype=torch.int32, device=dev)[:, None, None]
    big = torch.full_like(ts, t_total)
    starts = torch.where(hit, ts, big).amin(dim=0)
    ends = torch.where(hit, ts, -1).amax(dim=0)
    starts = torch.where(ends >= 0, starts, -1)
    return SegmentsResult(starts.to(torch.int32), ends.to(torch.int32))


def _labels_from_positions(positions, lat_targets):
    """``targets[b, positions[t, b]]`` with -1 at padding frames."""
    picked = _select_rows(lat_targets.to(torch.int32), positions.T.clamp(min=0)).T
    return torch.where(positions >= 0, picked, -1).to(torch.int32)


def viterbi_align(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    *,
    impl: str = "auto",
) -> AlignmentResult:
    """Best monotonic target-to-frame alignment (segmentation) per element.

    transition: (N, N), [i, j] = score of j -> i; inputs: (T, B, N);
    targets: (B, S) int labels.  impl: 'pallas' | 'xla' | 'auto' (see the
    module docstring).  An element with no alignment, a target length
    outside [1, S] or an input length outside [1, T], scores -inf.
    """
    t_total, num_batches, _ = inputs.shape
    s_total = targets.shape[1]
    dev = inputs.device
    if target_lengths is None:
        target_lengths = default_lengths(num_batches, s_total, dev)
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, dev)
    input_lengths = input_lengths.to(dev)
    target_lengths = target_lengths.to(dev)
    if inputs.dtype in (torch.bfloat16, torch.float16):
        inputs = inputs.float()
    transition = transition.to(device=dev, dtype=inputs.dtype)
    lat = make_aligned(transition, inputs, targets.to(dev), input_lengths, target_lengths)

    if impl == "auto":
        impl = "pallas" if inputs.is_cuda and s_total <= ALIGN_KERNEL_MAX_WIDTH else "xla"
    if impl == "pallas":
        if s_total > ALIGN_KERNEL_MAX_WIDTH:
            raise ValueError(
                f"impl='pallas' runs one thread per target slot in one block and "
                f"supports S <= {ALIGN_KERNEL_MAX_WIDTH}; got {s_total}.  Use "
                f"impl='xla' for longer targets.")
        forward, backtrace = align_forward_pallas, align_backtrace_pallas
    elif impl == "xla":
        forward, backtrace = align_forward_plain, align_backtrace_plain
    else:
        raise ValueError(f"unknown impl {impl!r}; expected 'auto', 'pallas', or 'xla'")
    end_s = (target_lengths - 1).to(torch.int32)
    d_end, adv = forward(lat, input_lengths)
    positions = backtrace(end_s, adv, input_lengths)
    # no alignment exists for a target length outside [1, S]: -inf, as for an
    # input length outside [1, T] (``_select_row`` alone would read 0 there)
    alignable = (target_lengths >= 1) & (target_lengths <= s_total)
    scores = torch.where(alignable, _select_row(d_end, end_s), NEG_INF)
    return AlignmentResult(scores, positions, _labels_from_positions(positions, lat.targets))


class NBestResult(NamedTuple):
    scores: torch.Tensor  # (B, K) best-path scores, descending per element
    paths: torch.Tensor  # (T, B, K) int32 labels, -1 at padding frames


def _topk(x: torch.Tensor, k: int):
    """The k largest entries along the last axis, as ``lax.top_k`` gives
    them: (values, int32 indices), equal values in ascending index order,
    -inf ties included.  ``torch.topk`` promises no order among equal
    values, so this is a stable descending sort cut to k, at every width."""
    if k > x.shape[-1]:
        raise ValueError(f"_topk: k={k} exceeds last-axis width {x.shape[-1]}")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _maxplus_topk(transition, d_prev, k):
    """(vals, flat_idx) of the top k over (j, r) of
    ``transition[i, j] + d_prev[b, j, r]``, flat index j * k + r.  Past
    ``_CHUNK_MIN_LABELS // k`` labels the destination rows go in chunks of
    ``_CHUNK_SIZE // k``, so only (B, chunk, N * k) is live."""
    num_labels = transition.shape[0]
    num_batches = d_prev.shape[0]

    def top(rows):
        cand = rows[None, :, :, None] + d_prev[:, None, :, :]
        return _topk(cand.reshape(num_batches, rows.shape[0], num_labels * k), k)

    if num_labels <= max(1, _CHUNK_MIN_LABELS // k):
        return top(transition)
    vals, idx = zip(*(top(rows) for rows in torch.split(transition, max(1, _CHUNK_SIZE // k))))
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def viterbi_nbest(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    k: int,
    input_lengths: Optional[torch.Tensor] = None,
) -> NBestResult:
    """The k best label paths per batch element (for LM rescoring).

    The lattice state is (label, rank): slot (i, r) holds the score of the
    r-th best path ending in label i, so the k slots of a label are k
    distinct paths and the final top k over all (i, r) are the k best paths.
    Rank 0 is ``viterbi_decode``'s path.  If fewer than k paths exist (k > N
    at T = 1), the tail ranks score -inf.  Work is O(T B N^2 k).
    """
    t_total, num_batches, num_labels = inputs.shape
    transition, inputs, input_lengths = _decode_inputs(transition, inputs, input_lengths)
    inputs_m = mask_emissions(inputs, input_lengths)
    last = (input_lengths - 1)[:, None]

    d = torch.full((num_batches, num_labels, k), NEG_INF, dtype=inputs.dtype,
                   device=inputs.device)
    d[:, :, 0] = inputs_m[0]
    d_end, backptr = d, []
    for t in range(1, t_total):
        vals, idx = _maxplus_topk(transition, d, k)
        d = inputs_m[t][:, :, None] + vals
        d_end = torch.where((last == t)[:, :, None], d, d_end)
        backptr.append(idx.reshape(num_batches, num_labels * k))
    scores, flat_fin = _topk(d_end.reshape(num_batches, num_labels * k), k)

    # the backtrace in flat (label * k + rank) coordinates, masked at each
    # element's end as the 1-best decoder's; -1 marks padding frames
    pad = torch.full_like(flat_fin, -1)
    flat = torch.where(last == t_total - 1, flat_fin, pad)
    flats = [flat]
    for t in range(t_total - 2, -1, -1):
        prev = _select_rows(backptr[t], flat.clamp(min=0))
        flat = torch.where(last == t, flat_fin, torch.where(t < last, prev, pad))
        flats.append(flat)
    flat_all = torch.stack(flats[::-1])
    paths = torch.where(flat_all >= 0, torch.div(flat_all, k, rounding_mode="floor"), -1)
    return NBestResult(scores, paths.to(torch.int32))


def beam_decode(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    beam_size: int = 16,
) -> ViterbiResult:
    """Beam-pruned Viterbi decode: the ``beam_size`` best labels survive each
    frame, so a step is O(B N K) (the live labels' outgoing transition rows,
    a max over them, a top K over N) where the exact step is O(B N^2).

    ``scores`` lower-bounds the exact Viterbi score, with equality whenever
    the best path's label at every frame lies inside that frame's beam; it
    does not fall as ``beam_size`` grows, and ``beam_size >= N`` gives
    ``viterbi_decode``'s scores.  Ties go to the lowest (score-ranked) beam
    slot, not the lowest source label, so on exact ties an equally scoring
    path may differ from ``viterbi_decode``'s.

    transition: (N, N), [i, j] = score of j -> i; inputs: (T, B, N).
    """
    d_end, labs, bps, input_lengths = _beam_forward(transition, inputs, input_lengths,
                                                    beam_size)
    start = torch.zeros((inputs.shape[1], 1), dtype=torch.int32, device=labs.device)
    return ViterbiResult(d_end[:, 0], _beam_backtrace(labs, bps, input_lengths, start)[:, :, 0])


def _beam_forward(transition, inputs, input_lengths, beam_size):
    """The beam-pruned forward pass of ``beam_decode`` and ``beam_nbest``:
    (d_end (B, K) the end-frame beam scores, descending; labs (T, B, K) the
    beam's labels at each frame; bps (T, B, K) slot at t -> slot at t - 1,
    row 0 zeros and never followed; input_lengths)."""
    t_total, num_batches, num_labels = inputs.shape
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    k = min(beam_size, num_labels)
    transition, inputs, input_lengths = _decode_inputs(transition, inputs, input_lengths)
    inputs_m = mask_emissions(inputs, input_lengths)
    trans_t = transition.T.contiguous()  # (from, to): row j holds j's outgoing scores
    last = (input_lengths - 1)[:, None]

    d, lab = _topk(inputs_m[0], k)
    d_end, labs = d, [lab]
    bps = [torch.zeros_like(lab)]
    for t in range(1, t_total):
        cand = trans_t[lab.long()] + d[:, :, None]  # (B, K, N)
        best = cand.amax(dim=1)
        from_slot = torch.argmax(cand, dim=1).to(torch.int32)  # first maximal slot
        d, lab = _topk(inputs_m[t] + best, k)
        bps.append(_select_rows(from_slot, lab))
        d_end = torch.where(last == t, d, d_end)
        labs.append(lab)
    return d_end, torch.stack(labs), torch.stack(bps), input_lengths


def _beam_backtrace(labs, bps, input_lengths, start):
    """(T, B, R) paths, path r starting from beam slot ``start[b, r]`` at
    each element's last frame; -1 at padding frames."""
    t_total = labs.shape[0]
    last = (input_lengths - 1)[:, None]
    pad = torch.full_like(start, -1)
    slot = start
    emits = [torch.where(last == t_total - 1, _select_rows(labs[-1], start), pad)]
    for t in range(t_total - 2, -1, -1):
        slot = torch.where(last == t, start, _select_rows(bps[t + 1], slot))
        emits.append(torch.where(t <= last, _select_rows(labs[t], slot), pad))
    return torch.stack(emits[::-1])


def beam_nbest(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    n: int,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    beam_size: int = 16,
) -> NBestResult:
    """The n best final-label hypotheses of one beam-pruned pass: one
    ``beam_decode`` forward, then a backtrace from each of the n best final
    beam slots.

    The n paths are the best surviving path ending in each of the n
    highest-scoring final beam labels: distinct final labels, each score
    exact for its path, scores descending, rank 0 equal to ``beam_decode``.
    It is not the global n-best (use ``viterbi_nbest`` for that below
    wordpiece scale); with ``beam_size >= N`` it is, for each of the n best
    final labels, the best path ending there.  Requires ``n <= beam_size``
    and ``n <= N``.
    """
    num_labels = inputs.shape[2]
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if n > beam_size:
        raise ValueError(
            f"n={n} exceeds beam_size={beam_size}; the beam only carries "
            f"beam_size final hypotheses")
    if n > num_labels:
        raise ValueError(
            f"n={n} exceeds num_labels={num_labels}; final labels are "
            f"distinct by construction so at most N hypotheses exist")
    d_end, labs, bps, input_lengths = _beam_forward(transition, inputs, input_lengths,
                                                    beam_size)
    start = torch.arange(n, dtype=torch.int32, device=labs.device).repeat(inputs.shape[1], 1)
    return NBestResult(d_end[:, :n], _beam_backtrace(labs, bps, input_lengths, start))
