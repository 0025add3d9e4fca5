"""Independent random streams derived from one run seed.

Every input of a run (weights, utterances, transcripts, the sample of
requests checked) comes from ``--seed`` through a stream of its own, named
by a tuple of small integers, so that adding a stream never shifts another.
"""

from __future__ import annotations

import numpy as np

WEIGHTS, UTTERANCES, SAMPLE = 1, 2, 3


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A NumPy generator for the stream ``keys`` of ``seed``; any
    non-negative whole number is a seed, 64 bits and more included."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *keys]))


def torch_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, for the stream ``keys``."""
    words = np.random.SeedSequence([int(seed), *keys]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])
