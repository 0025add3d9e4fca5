"""Profiling utilities: the program's spans and a thin wrapper over
``torch.profiler``.

Spans are ``torch.profiler`` host events, opened only while a profiler is
collecting (``span``, ``spanned``).  They land in the profiler's timeline
beside the device rows, so each kernel is tied to the spans open on the
thread that launched it; they stay in the profiler's memory until whoever
holds the profile exports it (``trace`` writes a Chrome trace).  The
program opens these:

==================================  ==========================================
``asg.encoder``                     ``Wav2Letter.forward``, the whole body
``asg.encoder.frontend``            the strided front end (``blocks[0]``)
``asg.encoder.mid``                 the stride-1 mid stack (``blocks[1:-1]``)
``asg.encoder.wide``                the last block (channels -> head_channels)
``asg.encoder.gated``               ``GatedConvNet``'s 17 gated convolutions
``asg.encoder.head``                ``GatedConvNet``'s two linear layers
``asg.weight_norm``                 ``GatedConvNet``'s weights from their
                                    (v, g) pairs, every layer's, once a
                                    forward
``asg.<stretch>.backward``          that stretch's backward, on the thread
                                    that runs it (the autograd engine's on
                                    the card); for every stretch above but
                                    ``asg.encoder``
``asg.conv``                        one forward call of a stride-1 block on the
                                    hand-written convolution
                                    (``conv_kernels.conv_relu``, ``conv_bias``)
``asg.grad_allreduce``              the tensor- and data-parallel step's
                                    all-reduce of the encoder's gradients
                                    over 'data' (``models/train.py``)
``asg.criterion``                   ``asg.py::_scores``, every tier
``asg.host_sync``                   where the host waits on the device: the
                                    spread guard's ``.tolist()``,
                                    ``collapse_path``'s ``.cpu()`` of a tensor
``asg.decode``                      ``viterbi_decode``
``asg.collapse``                    one ``collapse_path`` call
==================================  ==========================================
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import torch
from torch._C._profiler import _RecordFunctionFast


# what ``span`` returns while no profiler collects: one context for every call
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` span called ``name`` while a profiler is
    collecting; otherwise one shared no-op context.  The span is the
    profiler's own record function, without ``torch.profiler.record_function``'s
    Python wrapper and dispatcher calls, which cost several times as much a
    span; a traced serving request opens 64 collapse spans."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _NO_SPAN


class _BackwardSpan:
    """A span opened and closed by the autograd engine as it runs a
    stretch of the backward pass."""

    def __init__(self, name: str):
        self.name, self.record = name, None

    def open(self) -> None:
        if self.record is None:  # the first of several openers opens it
            self.record = _RecordFunctionFast(self.name)
            self.record.__enter__()

    def close(self, *_) -> None:
        if self.record is not None:
            self.record.__exit__(None, None, None)
            self.record = None


class _OnBackward(torch.autograd.Function):
    """Identity whose backward, run when the gradient reaches it, calls
    ``action`` (a span's open or close)."""

    @staticmethod
    def forward(ctx, x, action):
        ctx.action = action
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.action()
        return grad, None


def _next_sequence_nr() -> int:
    """The sequence number autograd gives the next node made on this thread."""
    return (torch.empty(0, requires_grad=True) * 1).grad_fn._sequence_nr() + 1


def _last_node(roots, floor: int):
    """The node of the graphs of ``roots`` made since sequence number
    ``floor`` that the engine runs last: the one made first in the
    forward, the leaves' accumulators and every node made before ``floor``
    (such as the weights a stretch reads, made earlier) aside.  Called
    where the stretch's inputs need no gradient, so every such node is the
    stretch's."""
    seen, todo, nodes = set(), list(roots), []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ != "AccumulateGrad" and node._sequence_nr() >= floor:
            nodes.append(node)
            todo.extend(n for n, _ in node.next_functions)
    return min(nodes, key=lambda n: n._sequence_nr())


def spanned(name: str, fn: Callable, *args):
    """``fn(*args)`` in the span ``name``; ``fn`` returns a tensor or a tuple
    of tensors.  While a profiler is collecting and autograd records, its
    backward runs in the span ``name + ".backward"``: identity functions at
    the stretch's ends open it (the first output's gradient to be taken)
    and close it (the first argument's), or, where no argument needs a
    gradient, a hook on the stretch's last node closes it (no gradient is
    added for an argument).  Without a profiler nothing is added to the
    graph; gradients are the same bits either way."""
    with span(name):
        if not (torch.autograd._profiler_enabled() and torch.is_grad_enabled()):
            return fn(*args)
        mark = _BackwardSpan(name + ".backward")
        grads = any(a.requires_grad for a in args)
        floor = _next_sequence_nr()
        args = [_OnBackward.apply(a, mark.close) if a.requires_grad else a for a in args]
        y = fn(*args)
        outs = y if isinstance(y, tuple) else (y,)
        if not any(o.requires_grad for o in outs):
            return y
        if not grads:
            _last_node([o.grad_fn for o in outs], floor).register_hook(mark.close)
        outs = tuple(_OnBackward.apply(o, mark.open) if o.requires_grad else o for o in outs)
        return outs if isinstance(y, tuple) else outs[0]


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

