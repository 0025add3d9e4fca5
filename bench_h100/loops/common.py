"""Pieces the loops share: the device's clock and memory, windows, and the
program's model built from the benchmark's weights."""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch

from .. import trace as tr
from .. import weights


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.empty(0, device=device)  # the allocator exists once the device is in use
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program_model(config: dict, w: dict, device):
    """The port's ``Wav2Letter`` at the configuration's widths, holding the
    benchmark's weights."""
    from torch_asg_tpu_torch.models import Wav2Letter

    model = Wav2Letter(**config["model"], device=device, dtype=getattr(torch, config["dtype"]))
    model.load_state_dict(weights.encoder_state(w))
    return model


class Marks:
    """Seconds from the process's start at which each part of set-up ended."""

    def __init__(self, cell):
        self.cell, self.at = cell, {}
        self("start")

    def __call__(self, label: str) -> None:
        self.at[label] = round(time.time() - self.cell.started, 3)


class Window:
    """The measured window: host-clock bounds, the ``bench.window`` span,
    and with ``trace`` a profiler around it.  ``tick()`` after each step or
    request stamps it and says whether ``seconds`` have passed."""

    def __init__(self, device, seconds: float, trace: bool):
        self.device, self.seconds, self.trace = device, seconds, trace
        self.stamps, self.prof, self.result = [], None, None

    def __enter__(self):
        sync(self.device)
        self._stack = contextlib.ExitStack()
        if self.trace:
            self.prof = self._stack.enter_context(tr.profile())
        self._stack.enter_context(torch.profiler.record_function(tr.WINDOW))
        sync(self.device)
        self.t0 = time.perf_counter()
        self.opened = time.time()
        return self

    def tick(self) -> bool:
        now = time.perf_counter() - self.t0
        self.stamps.append(now)
        return now >= self.seconds

    def __exit__(self, *exc):
        sync(self.device)
        self.seconds_taken = time.perf_counter() - self.t0
        self._stack.close()
        if self.trace and exc[0] is None:
            self.result = tr.Trace(self.prof)
        return False

    def per_second(self) -> list:
        """Steps or requests completed in each whole second of the window."""
        c = Counter(int(s) for s in self.stamps)
        return [c.get(i, 0) for i in range(int(max(self.stamps, default=0)) + 1)]
