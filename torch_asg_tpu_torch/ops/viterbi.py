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
    impl: 'pallas' | 'xla' | 'auto' (see the module docstring).
    """
    t_total, num_batches, num_labels = inputs.shape
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, inputs.device)
    input_lengths = input_lengths.to(inputs.device)
    # path scores accumulate over T steps, too long for half-precision mantissas
    if inputs.dtype in (torch.bfloat16, torch.float16):
        inputs = inputs.float()
    transition = transition.to(device=inputs.device, dtype=inputs.dtype)

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
