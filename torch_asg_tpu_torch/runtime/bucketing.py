"""Length-bucketed batching: a closed set of batch shapes.

Every distinct padded (T, B, S) triple is one more shape for the encoder's
convolutions to plan and for a captured graph to hold; a serving process fed
raw ragged utterances would see an unbounded set of them.  This module rounds
lengths up to a fixed bucket ladder and packs fixed-size batches, so a
deployment touches at most ``len(time_buckets) * len(target_buckets)``
shapes.

The padding itself is semantically free: the criterion and the decoders mask
by ``input_lengths``/``target_lengths``, so a bucket-padded batch gives the
same per-element results as the tight one (``tests/test_torch_port_runtime.py``
holds ``asg_loss`` to that).  Packing runs through ``pack_frames``.
"""

from __future__ import annotations

import bisect
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .host import encode_targets, pack_frames

__all__ = ["pick_bucket", "bucket_ladder", "BucketBatcher"]


def bucket_ladder(max_value: int, num_buckets: int = 8, min_value: int = 16):
    """A geometric bucket ladder ending exactly at ``max_value``."""
    if num_buckets < 1 or max_value < min_value:
        raise ValueError(
            f"need num_buckets >= 1 and max_value >= min_value; got "
            f"{num_buckets}, {max_value} < {min_value}"
        )
    if num_buckets == 1:
        return [max_value]
    ratio = (max_value / min_value) ** (1.0 / (num_buckets - 1))
    raw = [int(round(min_value * ratio ** i)) for i in range(num_buckets)]
    raw[-1] = max_value  # exact top rung (rounding must not add a rung)
    return sorted(set(raw))


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; raises if none fits."""
    i = bisect.bisect_left(buckets, length)
    if i == len(buckets):
        raise ValueError(
            f"length {length} exceeds the largest bucket {buckets[-1]}"
        )
    return buckets[i]


class BucketBatcher:
    """Accumulate ragged (features, labels) pairs into bucket-shaped
    batches.

    Each yielded batch dict has features (T_bucket, batch_size, F),
    feature_lengths, targets (batch_size, S_bucket), target_lengths —
    every array shape drawn from the fixed bucket grid.  Utterances are
    grouped by their TIME bucket (the dominant shape axis); the target
    axis is padded to the single ``target_bucket`` covering the batch's
    longest encoded target, rounded up on the target ladder.

    ``flush()`` drains partial groups, padding the batch dimension with
    repeats of the last utterance and ``pad_mask`` marking real rows
    (fixed batch size keeps the shape set closed; masked-out rows cost
    compute but not correctness — use ``reduction='none'`` and drop
    them, or scale a mean by ``pad_mask``).
    """

    def __init__(
        self,
        batch_size: int,
        time_buckets: Sequence[int],
        target_buckets: Sequence[int],
        alphabet_size: int = 0,
        max_reps: int = 2,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if not time_buckets or not target_buckets:
            raise ValueError("need at least one time and one target bucket")
        self.batch_size = batch_size
        self.time_buckets = sorted(time_buckets)
        self.target_buckets = sorted(target_buckets)
        self.alphabet_size = alphabet_size
        self.max_reps = max_reps
        self._groups: dict = {b: [] for b in self.time_buckets}

    def _encode(self, labels):
        if self.alphabet_size:
            enc, lens = encode_targets(
                [np.asarray(labels, np.int64)], self.alphabet_size,
                self.max_reps,
            )
            return enc[0], int(lens[0])
        arr = np.asarray(labels, np.int32)
        return arr, int(arr.shape[0])

    def _emit(self, bucket_t: int, pad: bool):
        group = self._groups[bucket_t]
        if not group or (not pad and len(group) < self.batch_size):
            return None
        batch, rest = group[: self.batch_size], group[self.batch_size :]
        self._groups[bucket_t] = rest
        real = len(batch)
        while len(batch) < self.batch_size:  # only when flushing
            batch.append(batch[-1])

        feats = [u for (u, _, _) in batch]
        feats.append(np.zeros((bucket_t,) + feats[0].shape[1:], feats[0].dtype))
        packed, lengths = pack_frames(feats)  # pads T to bucket_t
        packed, lengths = packed[:, :-1], lengths[:-1]

        s_needed = max(s for (_, _, s) in batch)
        bucket_s = pick_bucket(max(1, s_needed), self.target_buckets)
        targets = np.zeros((self.batch_size, bucket_s), np.int32)
        target_lengths = np.zeros((self.batch_size,), np.int32)
        for i, (_, enc, s_len) in enumerate(batch):
            targets[i, :s_len] = enc[:s_len]
            target_lengths[i] = s_len
        mask = np.zeros((self.batch_size,), bool)
        mask[:real] = True
        return dict(
            features=packed,
            feature_lengths=lengths.astype(np.int32),
            targets=targets,
            target_lengths=target_lengths,
            pad_mask=mask,
        )

    def add(self, features: np.ndarray, labels) -> Optional[dict]:
        """Queue one utterance; returns a full batch when one completes."""
        t = int(features.shape[0])
        bucket_t = pick_bucket(t, self.time_buckets)
        enc, s_len = self._encode(labels)
        self._groups[bucket_t].append((np.asarray(features), enc, s_len))
        return self._emit(bucket_t, pad=False)

    def flush(self) -> List[dict]:
        """Drain all partial groups as padded batches."""
        out = []
        for bucket_t in self.time_buckets:
            while self._groups[bucket_t]:
                out.append(self._emit(bucket_t, pad=True))
        return [b for b in out if b is not None]

    def batches(self, items: Iterable) -> Iterator[dict]:
        """Stream (features, labels) pairs through the batcher."""
        for features, labels in items:
            b = self.add(features, labels)
            if b is not None:
                yield b
        yield from self.flush()
