"""Start one process per rank on this host, run a function in each, and
collect what each returns.

``spawn_ranks(fn, world, args)`` starts ``world`` processes (the ``spawn``
method), each of which joins the process group through
``init_distributed`` at a free localhost port, runs ``fn(rank, world,
*args)`` and sends its result back.  The parent waits for every rank
within ``timeout_s``: a rank that raises, exits without a result or runs
past the deadline fails the whole call, and every rank still running is
killed, so a hung rendezvous or collective cannot outlive its caller.
``fn`` and its arguments and results must pickle (a module-level function;
numpy arrays or CPU tensors).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback

import torch.distributed as dist

from ..ops.kernels.common import DEFAULT_DEVICE
from .distributed import init_distributed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, args, results):
    try:
        init_distributed(f"127.0.0.1:{port}", world, rank, device=device)
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), *, device=DEFAULT_DEVICE,
                timeout_s: float = 600.0) -> list:
    """[fn's result on rank 0, ..., on rank world - 1]; raises RuntimeError
    with every failed rank's traceback if any rank fails or the deadline
    passes."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, world, port, device, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors, dead_since = {}, {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world and not errors:
            try:
                rank, ok, value = results.get(timeout=1.0)
                (got if ok else errors)[rank] = value
                continue
            except queue.Empty:
                pass
            now = time.monotonic()
            dead = [p.name for r, p in enumerate(procs) if r not in got and not p.is_alive()]
            if dead:
                # a rank's result reaches the queue before it exits: give it a moment
                dead_since = dead_since or now
                if now - dead_since > 5.0:
                    errors["exited"] = f"{dead} exited without a result"
            elif now > deadline:
                errors["deadline"] = f"ranks still running after {timeout_s} s"
    finally:
        # every rank still running once the call has failed is killed
        for p in procs:
            p.join(timeout=1.0 if errors else 30.0)
            if p.is_alive():
                p.kill()
                p.join()
    failed = dict(errors)
    failed.update({p.name: f"exit code {p.exitcode}" for r, p in enumerate(procs)
                   if p.exitcode != 0 and r not in errors})
    if failed:
        raise RuntimeError(f"ranks of {world} failed:\n"
                           + "\n".join(f"[{k}] {v}" for k, v in failed.items()))
    return [got[r] for r in range(world)]
