"""Batch data-parallel ASG and decoding over one mesh axis.

Utterances are split along the batch over ``mesh[axis]``; the (N, N)
transition matrix is replicated.  Its gradient is already a sum over the
batch, so each rank's local gradient is all-reduced once over the axis
(``collectives.replicated_input``, JAX's psum of a replicated input's
cotangent).  Each rank runs the port's single-process entry points on its
block: ``asg_loss`` (the fused tier's kernels K1 with stores and K2 on the
card under ``impl='auto'``), ``viterbi_decode`` (K10, K11),
``viterbi_align`` (K12, K13) and ``beam_decode``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..asg import REDUCTIONS, asg_loss
from ..ops.viterbi import (AlignmentResult, ViterbiResult, beam_decode, viterbi_align,
                           viterbi_decode)
from .collectives import (check_blocks, mesh_axis, mesh_device, replicated_input,
                          sum_over_ranks)


def shard_batch(mesh: DeviceMesh, axis: str, inputs, targets, input_lengths, target_lengths):
    """This rank's block of a global batch, on its device: inputs (T, B, N)
    split over B, targets (B, S), and the (B,) lengths."""
    ax = mesh_axis(mesh, axis)
    num_batches = inputs.shape[1]
    _dp_batch_check(num_batches, ax.size, axis)
    per = num_batches // ax.size
    rows = slice(ax.index * per, (ax.index + 1) * per)
    dev = mesh_device(mesh)
    return (inputs[:, rows].to(dev), targets[rows].to(dev),
            input_lengths[rows].to(dev), target_lengths[rows].to(dev))


def _dp_batch_check(num_batches: int, size: int, axis: str) -> None:
    if num_batches % size != 0:
        raise ValueError(
            f"batch {num_batches} not divisible by mesh axis {axis!r} = {size}"
        )


def _global_batch(mesh: DeviceMesh, axis: str, inputs):
    """(axis, global batch): the blocks of every rank must have one size."""
    ax = mesh_axis(mesh, axis)
    return ax, check_blocks(inputs.shape[1], ax, axis, "batch", inputs.device)


def asg_loss_dp(
    mesh: DeviceMesh,
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    *,
    axis: str = "data",
    reduction: str = "mean",
    impl: str = "auto",
) -> torch.Tensor:
    """ASG loss with the batch split over ``mesh[axis]``.

    Per-element results are those of the single-process path; 'mean' and
    'sum' reduce over the global batch, so every rank returns the same
    scalar ('mean' divides by the global batch).  Differentiable: each
    rank's emission gradient is its block of the single-process one, and
    the transition gradient the whole of it on every rank.
    """
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}; expected one of {REDUCTIONS}")
    ax, num_batches = _global_batch(mesh, axis, inputs)
    local = asg_loss(replicated_input(transition, ax), inputs, targets, input_lengths,
                     target_lengths, reduction="none", impl=impl)
    if reduction == "none":
        return local
    total = sum_over_ranks(local.sum(), ax)
    return total / num_batches if reduction == "mean" else total


def viterbi_decode_dp(
    mesh: DeviceMesh,
    transition: torch.Tensor,
    inputs: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    axis: str = "data",
    impl: str = "auto",
) -> ViterbiResult:
    """``ops.viterbi.viterbi_decode`` of this rank's block of the batch
    (decoding is batch-parallel: no traffic beyond the size check).

    Returns this rank's block: ``scores`` (B/P,) and ``paths`` (T, B/P).
    """
    _global_batch(mesh, axis, inputs)
    return viterbi_decode(transition, inputs, input_lengths, impl=impl)


def beam_decode_dp(
    mesh: DeviceMesh,
    transition: torch.Tensor,
    inputs: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    axis: str = "data",
    beam_size: int = 16,
) -> ViterbiResult:
    """``ops.viterbi.beam_decode`` of this rank's block of the batch: the
    batch-parallel form of the pruned wordpiece-scale decoder (each rank
    prunes its own beams).  Returns this rank's block."""
    _global_batch(mesh, axis, inputs)
    return beam_decode(transition, inputs, input_lengths, beam_size=beam_size)


def viterbi_align_dp(
    mesh: DeviceMesh,
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    *,
    axis: str = "data",
    impl: str = "auto",
) -> AlignmentResult:
    """``ops.viterbi.viterbi_align`` (forced alignment) of this rank's block
    of the batch; same contract as ``viterbi_decode_dp``."""
    _global_batch(mesh, axis, inputs)
    return viterbi_align(transition, inputs, targets, input_lengths, target_lengths,
                         impl=impl)
