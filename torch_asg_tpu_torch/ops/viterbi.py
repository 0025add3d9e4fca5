"""1-best Viterbi decoding in the tropical (max) semiring.

``viterbi_decode`` finds the best unconstrained label path through the
fully-connected lattice: the ASG recursion with (max, argmax) in place of
logsumexp, plus a backtrace.  Ragged lengths are masked as in the loss;
paths hold -1 at padding frames.

Tiers (``impl``):
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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels.viterbi_kernels import (VITERBI_KERNEL_MAX_LABELS, argmax_first,
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
