"""Multi-host initialization and hybrid (across hosts x within a host) meshes.

Three thin pieces, as in the JAX package:

  1. process bring-up: ``torch.distributed.init_process_group`` over a
     ``tcp://`` rendezvous at the coordinator, with retry, so a restarted
     worker can rejoin a training job;
  2. a mesh whose data axis spans hosts while the inner (model / seq) axes
     stay inside one host, so their collectives never cross the network
     between hosts: ``make_hybrid_mesh``;
  3. batch bookkeeping: every rank loads only its share,
     ``local_batch_slice``.

One process runs per rank (per card), where a JAX process drives every
device of its host.  NCCL carries the collectives on CUDA devices, gloo on
the CPU.  In a single process with no coordinator configured everything is
a no-op, so the same script runs anywhere.
"""

from __future__ import annotations

import math
import os
import socket
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.kernels.common import DEFAULT_DEVICE
from .mesh import world_size

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    retries: int = 3,
    retry_delay_s: float = 5.0,
    device=DEFAULT_DEVICE,
) -> bool:
    """Join the default process group with retry; returns True when there is
    more than one rank.

    ``coordinator_address`` is 'host:port' of rank 0's rendezvous,
    ``num_processes`` the world size and ``process_id`` this rank.  With no
    arguments the launcher's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, as torchrun sets them) supplies them; without
    that environment this is a single process and a no-op returning False.
    A group that already exists is kept.  A ``RuntimeError`` from the
    rendezvous (a restarted worker whose coordinator is not back yet) is
    retried ``retries`` times, and the last one raised; a ``ValueError``
    (a misconfiguration) always propagates.

    ``device`` picks the backend: NCCL for 'cuda', and then this rank's card
    (``LOCAL_RANK``, or the rank modulo the card count) becomes current;
    gloo for 'cpu'.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = (coordinator_address, num_processes, process_id) != (None, None, None)
    if not explicit:
        if not all(k in os.environ for k in _ENV):
            return False  # single process, no coordinator configured
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    # torch's own defaults: a tcp:// rendezvous without them raises ValueError
    world = -1 if num_processes is None else int(num_processes)
    rank = -1 if process_id is None else int(process_id)
    kind = torch.device(device).type
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    if backend is None:
        raise ValueError(f"no process-group backend for device type {kind!r}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device 'cuda' asks for NCCL, and no CUDA device is visible")
        local = int(os.environ.get("LOCAL_RANK", max(rank, 0) % cards))
        torch.cuda.set_device(local)
    last_err = None
    n_tries = max(1, retries)
    for attempt in range(n_tries):
        try:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=world, rank=rank)
            return (dist.get_world_size() if dist.is_initialized() else world) > 1
        except RuntimeError as e:  # the rendezvous failed (DistNetworkError, ...)
            last_err = e
            if attempt + 1 < n_tries:  # no pointless sleep after the last try
                time.sleep(retry_delay_s)
    raise last_err


def local_world_size() -> int:
    """Ranks on this rank's host: ``LOCAL_WORLD_SIZE`` when the launcher set
    it, else the ranks that report this host's name.  Ranks must be numbered
    host-major (rank = host * local ranks + local rank), as launchers do."""
    ranks = world_size()
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    hosts = [None] * ranks
    dist.all_gather_object(hosts, socket.gethostname())
    n_local = hosts.count(hosts[dist.get_rank()])
    if ranks % n_local or any(hosts[r] != hosts[r - r % n_local] for r in range(ranks)):
        raise ValueError(f"ranks are not numbered host-major: {hosts}")
    return n_local


def make_hybrid_mesh(
    inner_sizes: Sequence[int] = (),
    inner_names: Sequence[str] = (),
    *,
    data_axis: str = "data",
    device=DEFAULT_DEVICE,
) -> DeviceMesh:
    """(data, *inner) mesh: data-parallel across hosts, the inner axes
    (model / seq) over the ranks of one host.

    The transition-gradient all-reduce of the data axis is the only
    collective that may cross hosts; everything the vocabulary- and
    sequence-sharded paths run over the inner axes stays inside one host.
    """
    inner_sizes = tuple(int(s) for s in inner_sizes)
    if len(inner_sizes) != len(inner_names):
        raise ValueError(
            f"inner_sizes {inner_sizes} and inner_names {tuple(inner_names)} "
            f"must have the same length"
        )
    inner = math.prod(inner_sizes)
    n_local = local_world_size()
    if inner > n_local or n_local % inner != 0:
        raise ValueError(
            f"inner axes {inner_sizes} need a divisor of the per-host "
            f"rank count {n_local}"
        )
    ranks = world_size()
    # host-major ranks: each block of `inner` consecutive ranks lies in one host
    layout = torch.arange(ranks).reshape((ranks // inner, *inner_sizes))
    return DeviceMesh(torch.device(device).type, layout,
                      mesh_dim_names=(data_axis, *tuple(inner_names)))


def _rank_and_size():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a globally-indexed batch this rank should load."""
    rank, ranks = _rank_and_size()
    per = global_batch // ranks
    if per * ranks != global_batch:
        raise ValueError(
            f"global batch {global_batch} not divisible by {ranks} processes"
        )
    return slice(rank * per, (rank + 1) * per)
