"""The collectives of the per-rank bodies, and their gradients.

Each ``*_dp``, ``*_vp`` and ``*_seq`` function is the body one rank runs
(see the package docstring).  The JAX package gets the gradients of its
collectives from ``shard_map``'s transposes; here they are written out:

* ``replicated_input``: identity forward; the backward all-reduces the
  gradient once over the axis, so a replicated argument gets the whole
  gradient on every rank (JAX's psum of a replicated input's cotangent).
* ``sum_over_ranks``: all-reduce forward; the backward passes the gradient
  through as it is.  Its output is replicated, so every rank receives the
  same gradient, and each rank's own block takes it once.  (The backward of
  ``torch.distributed.nn.functional.all_reduce`` sums it over the ranks
  instead, which makes a loss that every rank differentiates P times too
  large.)
* ``gather_blocks``: all-gather forward, stacked on a new leading axis; the
  backward hands each rank its own slice of the gradient, which is the same
  on every rank, without summing it over the ranks.  ``gather_channels``
  concatenates those blocks along dim 1 (the tensor-parallel encoder's
  output channels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""

    group: dist.ProcessGroup
    size: int  # ranks along the axis
    index: int  # this rank's coordinate along the axis


def mesh_axis(mesh: DeviceMesh, axis: str) -> Axis:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {tuple(names)}")
    return Axis(mesh.get_group(axis), mesh.size(names.index(axis)),
                mesh.get_local_rank(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_blocks(local: int, ax: Axis, axis: str, what: str, device) -> int:
    """The global extent of a dimension whose blocks the ranks along ``ax``
    hold; raises unless every block has the same size (the global extent
    divisible by the axis), as the JAX package's shard_map requires."""
    mine = torch.tensor([local], dtype=torch.int64, device=device)
    sizes = torch.empty(ax.size, dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(sizes, mine, group=ax.group)
    sizes = sizes.tolist()
    total = sum(sizes)
    if total % ax.size != 0:
        raise ValueError(f"{what} {total} not divisible by mesh axis {axis!r} = {ax.size}")
    if len(set(sizes)) != 1:
        raise ValueError(f"{what} blocks along mesh axis {axis!r} differ in size: {sizes}")
    return total


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.index = index
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
        return out.view((size,) + x.shape)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None, None


def replicated_input(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return _Replicated.apply(x, ax.group)


def sum_over_ranks(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return _SumOverRanks.apply(x, ax.group)


def gather_blocks(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """(P, *x.shape): every rank's ``x`` along the axis, in rank order."""
    return _GatherBlocks.apply(x, ax.group, ax.size, ax.index)


def gather_channels(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """(B, P * C, ...): every rank's (B, C, ...) block of channels along the
    axis, concatenated along dim 1 in rank order (``gather_blocks``'s
    gradient: each rank gets back the gradient of its own channels)."""
    return torch.cat(tuple(gather_blocks(x, ax)), dim=1)
