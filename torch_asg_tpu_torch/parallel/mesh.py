"""Device-mesh helpers: a ``DeviceMesh`` over the ranks of the process group.

The JAX package builds a ``jax.sharding.Mesh`` over the devices one process
sees.  Here every rank is a process of its own (one per card), so a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, which ``init_distributed`` (or
``torch.distributed.init_process_group``) must have set up first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.kernels.common import DEFAULT_DEVICE


def world_size() -> int:
    """Ranks in the default process group; raises when there is none."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.init_distributed (or "
            "torch.distributed.init_process_group) on every rank first")
    return dist.get_world_size()


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    device=DEFAULT_DEVICE,
) -> DeviceMesh:
    """Build a mesh over every rank.

    make_mesh() -> 1D 'data' mesh over all ranks.
    make_mesh((4, 2), ('data', 'model')) -> 4x2 mesh, ranks row-major.
    ``device`` names the device type the ranks compute on ('cuda', or
    'cpu' for gloo).
    """
    ranks = world_size()
    sizes = (ranks,) if axis_sizes is None else tuple(int(s) for s in axis_sizes)
    need = math.prod(sizes)
    if need != ranks:
        raise ValueError(f"mesh axes {sizes} need {need} ranks, got {ranks}")
    return init_device_mesh(torch.device(device).type, sizes,
                            mesh_dim_names=tuple(axis_names))
