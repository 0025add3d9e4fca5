"""Profiling and timing utilities: a thin wrapper over ``torch.profiler``
and a timer whose every call waits on the one before it.

On the card, a host clock around a launch measures the enqueue, not the
work: ``time_fn_chained`` feeds each call's output into the next call's
input, so no call can start before the previous one finished, and closes
the loop with a synchronise and one scalar fetch.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Optional

import torch

from ..ops.kernels.common import DEFAULT_DEVICE


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a profiler trace of the CPU and, where there is one, the card
    into ``log_dir`` (a Chrome trace, ``trace-<pid>.json``, viewable in
    Perfetto or chrome://tracing) when ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))


def _first_tensor(out) -> torch.Tensor:
    """The first tensor in a (nested) tuple, list or dict of outputs."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else out
    for item in items:
        if isinstance(item, (torch.Tensor, tuple, list, dict)):
            return _first_tensor(item)
    raise TypeError(f"no tensor in {type(out).__name__}")


def _fetch(out) -> float:
    """Wait for ``out`` and bring one scalar of it to the host."""
    probe = _first_tensor(out)
    if probe.is_cuda:
        torch.cuda.synchronize(probe.device)
    return float(probe.reshape(-1)[0])


def fetch_overhead_s(samples: int = 5, device=DEFAULT_DEVICE) -> float:
    """Fixed host<->device round-trip cost of fetching one scalar (median).

    Measure this ONCE per process and pass it into time_fn_chained when
    timing several things: re-sampling it per measurement lets a lucky
    fetch estimate pair with a lucky loop."""
    t = torch.zeros((1,), device=device)
    _fetch(t + 1)
    obs = []
    for _ in range(samples):
        t0 = time.perf_counter()
        _fetch(t + 1)
        obs.append(time.perf_counter() - t0)
    return statistics.median(obs)


def time_fn_chained(
    step: Callable, feedback: Callable, x0, warmup: int = 2, iters: int = 30,
    fetch_s: Optional[float] = None,
) -> float:
    """Seconds per call: each iteration's input depends on the previous
    output, and the loop closes with a synchronise and one scalar fetch,
    whose own cost (``fetch_overhead_s``) is subtracted.

    step(x) -> out; feedback(x0, out) -> next x (must touch ``out``).
    """
    if fetch_s is None:
        fetch_s = fetch_overhead_s(device=_first_tensor(x0).device)
    cur = x0
    for _ in range(max(1, warmup)):
        out = step(cur)
        cur = feedback(x0, out)
    _fetch(out)
    t0 = time.perf_counter()
    cur = x0
    for _ in range(iters):
        out = step(cur)
        cur = feedback(x0, out)
    _fetch(out)
    return max((time.perf_counter() - t0) - fetch_s, 1e-9) / iters
