"""One ``torch.profiler`` window, reduced to what the per-layer readers ask.

The window is the benchmark's ``bench.window`` span.  Each device operation
(kernel, copy, fill) is tied to the moment it was launched: the CUDA call
that shares its correlation id, or else the start of the innermost host op
it links to.  At that moment its thread is inside a stack of host ops (the
autograd functions' own names, ``aten::`` ops, ``Optimizer.step#AdamW.step``,
the benchmark's ``bench.*`` spans), and the operation belongs to every op
of that stack.  Busy time is the union of the device operations' intervals
inside the window.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

# CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel, ...): a device
# row shares its correlation id with the call that launched it, and links
# (linked_correlation_id) to the innermost host op, whose ids are numbered apart
RUNTIME_PREFIX = "cu"
WINDOW = "bench.window"


def profile():
    """A profiler over host and device, with nothing recorded but the ops
    and their times."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  profile_memory=False, with_stack=False)


class Trace:
    """Device operations of the window with the names of the host ops
    that launched them, the host spans, busy time and idle gaps.  Plain
    data, which a process can hand to another."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        host, device = [], []
        for e in events:
            row = (e.start_ns(), e.end_ns(), e.name(), e.start_thread_id(),
                   e.correlation_id(), e.linked_correlation_id())
            (device if str(e.device_type()).endswith("CUDA") else host).append(row)
        # a device row named as a host op is the device side of a span, not work
        names = {r[2] for r in host}
        device = [(s, t, name, (corr, link)) for s, t, name, _, corr, link in device
                  if name not in names]
        ops = defaultdict(list)  # thread -> [(start, end, name)]
        calls, opened = {}, {}  # runtime calls by their id; host ops by theirs
        for s, t, name, tid, corr, _ in host:
            ops[tid].append((s, t, name))
            if name.startswith(RUNTIME_PREFIX):
                calls[corr] = (tid, s)
            elif " " not in name:  # the profiler's own rows may share an op's id
                opened[corr] = (tid, s)
        launch = {}  # (corr, link) -> (thread, time) of the launch
        for _, _, _, key in device:
            at = calls.get(key[0]) or opened.get(key[1])
            if at:
                launch[key] = at
        self.spans = defaultdict(list)  # name -> [(start, end)] of host ops
        for rows in ops.values():
            for s, t, name in rows:
                self.spans[name].append((s, t))
        if not self.spans.get(WINDOW):
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        self.start, self.end = self.spans[WINDOW][0]
        main = next(tid for tid, rows in ops.items() if any(n == WINDOW for _, _, n in rows))
        device = [d for d in device if d[1] > self.start and d[0] < self.end]
        stacks = self._stacks(ops, launch, device)
        # (duration ns, name, frozenset of host op names above it)
        self.ops = [(min(t, self.end) - max(s, self.start), name, stacks.get(corr, frozenset()))
                    for s, t, name, corr in device]
        merged = []
        for s, t in sorted((max(s, self.start), min(t, self.end)) for s, t, _, _ in device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_ns = sum(t - s for s, t in merged)
        self.idle = self._gaps(merged, sorted(ops[main]))

    @staticmethod
    def _stacks(ops, launch, device) -> dict:
        """{(corr, link) of a device row: names of the host ops around its
        launch}."""
        want = defaultdict(list)  # thread -> [(time, correlation id)]
        for _, _, _, corr in device:
            if corr in launch:
                tid, at = launch[corr]
                want[tid].append((at, corr))
        out = {}
        for tid, points in want.items():
            rows = sorted(ops.get(tid, ()), key=lambda r: (r[0], -r[1]))
            stack, i = [], 0
            for at, corr in sorted(points):
                while i < len(rows) and rows[i][0] <= at:
                    stack.append(rows[i])
                    i += 1
                stack = [r for r in stack if r[1] >= at]
                out[corr] = frozenset(r[2] for r in stack)
        return out

    def _gaps(self, merged, main_ops) -> list:
        """[(name, ns)]: the device's idle gaps inside the window, each under
        the innermost host op the dispatching thread was in when it began."""
        gaps, prev = [], self.start
        for s, t in merged + [[self.end, self.end]]:
            if s > prev:
                gaps.append((prev, s - prev))
            prev = max(prev, t)
        starts = [r[0] for r in main_ops]
        by = Counter()
        for at, ns in gaps:
            i = bisect.bisect_right(starts, at)
            inner = "host"
            for j in range(i - 1, max(i - 400, -1), -1):
                if main_ops[j][1] >= at:
                    inner = main_ops[j][2]
                    break
            by[inner] += ns
        return by.most_common()

    @property
    def window_ns(self) -> int:
        return self.end - self.start

    def device_ns(self, names) -> int:
        """Device ns of the operations launched inside a host op named in
        ``names``."""
        names = frozenset(names)
        return sum(ns for ns, _, above in self.ops if not names.isdisjoint(above))

    def host_ns(self, name: str) -> int:
        """Host ns inside spans called ``name`` within the window."""
        return sum(t - s for s, t in self.spans.get(name, ())
                   if s >= self.start and t <= self.end)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time and the longest idle gaps by
        host op, in seconds."""
        by = Counter()
        for ns, name, _ in self.ops:
            by[name[:96]] += ns
        return {"device_ops": [[n, ns / 1e9] for n, ns in by.most_common(top)],
                "idle_gaps": [[n[:96], ns / 1e9] for n, ns in self.idle[:top]]}
