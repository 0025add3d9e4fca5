"""Host-side data path, in NumPy.

Training batches go ``cmvn`` -> ``pack_frames`` -> ``encode_targets`` (as
``examples/train_asg.py::prepare_batch`` prepares them); serving turns a
framewise label path (a column of ``viterbi_decode``'s output) into a label
sequence with ``collapse_path``.  These are the NumPy forms; the native host
runtime comes with the runtime slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _check_utterances(utterances: Sequence[np.ndarray]) -> None:
    if utterances[0].ndim != 2:
        raise ValueError(
            f"utterance 0 has shape {utterances[0].shape}; expected (*, F)")
    feat_dim = utterances[0].shape[1]
    for b, u in enumerate(utterances):
        if u.ndim != 2 or u.shape[1] != feat_dim:
            raise ValueError(
                f"utterance {b} has shape {u.shape}; expected (*, {feat_dim}) "
                "— all utterances must share the feature dim")


def cmvn(utterances: Sequence[np.ndarray], epsilon: float = 1e-5,
         norm_var: bool = True) -> list:
    """Per-utterance cepstral mean (and variance) normalisation: new (T_b, F)
    float32 arrays, the inputs untouched.  Statistics are taken in float64."""
    if len(utterances) == 0:
        return []
    _check_utterances(utterances)
    out = []
    for u in utterances:
        u = np.asarray(u, np.float32)
        if u.shape[0] == 0:
            out.append(u.copy())
            continue
        mean = u.mean(axis=0, dtype=np.float64)
        if norm_var:
            var = u.var(axis=0, dtype=np.float64)
            out.append(((u - mean) / np.sqrt(var + epsilon)).astype(np.float32))
        else:
            out.append((u - mean).astype(np.float32))
    return out


def pack_frames(utterances: Sequence[np.ndarray],
                pad_value: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Pack ragged (T_b, F) utterances into (T_max, B, F) float32 + int32
    lengths."""
    num_batches = len(utterances)
    if num_batches == 0:
        return np.zeros((0, 0, 0), np.float32), np.zeros((0,), np.int32)
    _check_utterances(utterances)
    lengths = np.array([u.shape[0] for u in utterances], np.int32)
    out = np.full((int(lengths.max()), num_batches, utterances[0].shape[1]),
                  pad_value, np.float32)
    for b, u in enumerate(utterances):
        out[: u.shape[0], b] = u
    return out, lengths


def encode_labels_np(labels: np.ndarray, alphabet_size: int,
                     max_reps: int) -> np.ndarray:
    """The ASG repeat-symbol encoding of one label sequence: a run of r
    copies of a label becomes the label followed by the repeat symbol
    ``alphabet_size + min(r - 1, max_reps) - 1``, as often as the run needs."""
    out = []
    i = 0
    labels = np.asarray(labels).tolist()
    while i < len(labels):
        lab = labels[i]
        run = 1
        while i + run < len(labels) and labels[i + run] == lab:
            run += 1
        left = run
        while left > 0:
            out.append(lab)
            reps = min(left - 1, max_reps)
            if reps > 0:
                out.append(alphabet_size + reps - 1)
            left -= 1 + reps
        i += run
    return np.asarray(out, np.int32)


def encode_targets(sequences: Sequence[np.ndarray], alphabet_size: int,
                   max_reps: int = 2,
                   pad_value: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Batch-encode label sequences into the ASG extended alphabet (size
    ``alphabet_size + max_reps``): (targets (B, S_max) int32, target_lengths
    (B,) int32), S_max at least 1."""
    num_batches = len(sequences)
    if num_batches == 0:
        return np.zeros((0, 1), np.int32), np.zeros((0,), np.int32)
    encoded = [encode_labels_np(s, alphabet_size, max_reps) for s in sequences]
    lengths = np.array([len(e) for e in encoded], np.int32)
    out = np.full((num_batches, max(int(lengths.max()), 1)), pad_value, np.int32)
    for b, e in enumerate(encoded):
        out[b, : len(e)] = e
    return out, lengths


def collapse_path(path, alphabet_size: int = 0, max_reps: int = 2) -> np.ndarray:
    """Drop -1 padding, merge runs of one label, and, when
    ``alphabet_size > 0``, expand the ``max_reps`` repeat symbols of the ASG
    extended alphabet (labels ``alphabet_size .. alphabet_size + max_reps - 1``
    stand for 1 .. max_reps repeats of the previous label).  With
    ``alphabet_size == 0`` it is a plain merge and ``max_reps`` is ignored.
    ``path`` may be a NumPy array or a tensor on any device."""
    if hasattr(path, "detach"):
        path = path.detach().cpu().numpy()
    out = []
    prev = -1
    for lab in np.asarray(path, np.int32).tolist():
        if lab < 0 or lab == prev:
            continue
        prev = lab
        if alphabet_size > 0 and alphabet_size <= lab < alphabet_size + max_reps:
            if out:
                out.extend([out[-1]] * (lab - alphabet_size + 1))
        else:
            out.append(lab)
    return np.asarray(out, np.int32)
