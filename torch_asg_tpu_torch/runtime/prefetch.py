"""Asynchronous host-side input pipeline.

A training step on the card takes tens of milliseconds; preparing its batch
on the host (CMVN, ragged-batch packing, target encoding: the native library
of ``host.py``, which releases the GIL for the length of each call) and
copying it to the card take about as long.  ``BatchPrefetcher`` runs a
``prepare_fn`` over an item iterator in a background thread with a bounded
queue, so the next ``depth`` batches are prepared while the loop waits on
the card.  ``device_prefetch`` also copies each batch to the card from that
thread, on a side CUDA stream, so the copy overlaps the step as well.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

__all__ = ["BatchPrefetcher", "device_prefetch"]

_DONE = object()


class BatchPrefetcher:
    """Iterate ``prepare_fn(item)`` for each item, prepared ahead of time.

    Args:
      items: the source iterable (e.g. lists of raw utterances).
      prepare_fn: runs IN THE WORKER THREAD; typically cmvn + pack_frames
        + encode_targets.  Exceptions propagate to the
        consumer at the matching ``__next__`` call.
      depth: max prepared batches in flight (bounded queue).

    Use as a context manager or call ``close()`` to stop early; the
    worker exits promptly once the queue drains.
    """

    def __init__(
        self,
        items: Iterable,
        prepare_fn: Callable,
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._prepare = prepare_fn
        self._worker = threading.Thread(
            target=self._run, args=(iter(items),), daemon=True
        )
        self._worker.start()

    def _put_responsive(self, out):
        # bounded put that stays responsive to close(); a plain put() on a
        # full queue would deadlock against a consumer that stopped reading
        while not self._stop.is_set():
            try:
                self._q.put(out, timeout=0.1)
                break
            except queue.Full:
                continue

    def _run(self, it: Iterator):
        try:
            for item in it:
                if self._stop.is_set():
                    break
                self._put_responsive((self._prepare(item), None))
        except BaseException as exc:  # re-raised in the consumer
            self._put_responsive((None, exc))
            return
        self._put_responsive(_DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set() or self._exhausted:
            raise StopIteration
        # timed get that re-checks _stop: a close() from another thread
        # sets _stop and enqueues nothing (the worker's _put_responsive
        # no-ops once stopped), so an unbounded get() here would block
        # that consumer forever
        while True:
            try:
                got = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
        if got is _DONE:
            # keep raising on any further call (iterator protocol) —
            # there is exactly one _DONE sentinel in the queue
            self._exhausted = True
            raise StopIteration
        batch, exc = got
        if exc is not None:
            self.close()
            raise exc
        return batch

    def close(self):
        """Stop the worker and drop queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _CudaPrefetcher(BatchPrefetcher):
    """Hands over batches copied on a side stream: the consumer's current
    stream waits on each batch's copy, and each tensor is recorded on that
    stream, so the caching allocator does not reuse its memory while the
    consumer may still read it."""

    def __init__(self, items, prepare_fn, depth, device):
        self._device = device
        super().__init__(items, prepare_fn, depth=depth)

    def __next__(self):
        batch, copied = super().__next__()
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(copied)
        _tree_map(lambda t: t.record_stream(stream), batch)
        return batch


def device_prefetch(items: Iterable, prepare_fn: Callable, depth: int = 2,
                    device="cuda") -> BatchPrefetcher:
    """``BatchPrefetcher`` over ``prepare_fn`` (which returns a pytree of
    NumPy arrays: nested dicts, lists and tuples), with each batch moved to
    ``device`` still inside the worker thread, so host prep and the copy
    overlap the device step.  Yields the same pytree of tensors on
    ``device``.

    On a CUDA device the worker puts the arrays into pinned host memory,
    copies them with ``non_blocking=True`` on a side stream of that device
    and records an event; the consumer's current stream waits on the event
    before it gets the batch.  Nothing in the worker synchronises the
    device.  On any other device the copy is a plain ``.to(device)``.

    The JAX package's ``device_prefetch`` takes a ``sharding`` for
    ``jax.device_put``; here ``device`` takes its place, and sharded batches
    wait for the multi-GPU module.
    """
    device = torch.device(device)
    if device.type != "cuda":
        def prepare_and_move(item):
            return _tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(device),
                             prepare_fn(item))

        return BatchPrefetcher(items, prepare_and_move, depth=depth)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device=device)

    def prepare_and_copy(item):
        host = prepare_fn(item)
        with torch.cuda.device(device), torch.cuda.stream(side):
            pinned = _tree_map(lambda a: torch.as_tensor(np.asarray(a)).pin_memory(), host)
            batch = _tree_map(lambda t: t.to(device, non_blocking=True), pinned)
            copied = torch.cuda.Event()
            copied.record(side)
        return batch, copied

    return _CudaPrefetcher(items, prepare_and_copy, depth, device)
