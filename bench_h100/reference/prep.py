"""Host preparation, written again: CMVN, packing, the ASG repeat-label
encoding, and the collapse of a decoded path to a hypothesis."""

from __future__ import annotations

import numpy as np

CMVN_EPS = 1e-5


def cmvn(u: np.ndarray) -> np.ndarray:
    """Per-utterance mean and variance normalisation, in float64."""
    x = np.asarray(u, np.float64)
    return (x - x.mean(axis=0)) / np.sqrt(x.var(axis=0) + CMVN_EPS)


def pack(utts, t_pad: int) -> tuple:
    """(features (B, t_pad, F) float64, zero past each length; lengths (B,))."""
    out = np.zeros((len(utts), t_pad, utts[0].shape[1]), np.float64)
    for b, u in enumerate(utts):
        out[b, :len(u)] = cmvn(u)
    return out, np.array([len(u) for u in utts], np.int64)


def encode(labels, alphabet: int, max_reps: int) -> list:
    """ASG targets: each run of r equal labels becomes the label, then the
    repeat label ``alphabet + k - 1`` for k = min(r - 1, max_reps) more
    copies, as often as the run needs."""
    out, i, seq = [], 0, list(np.asarray(labels).tolist())
    while i < len(seq):
        j = i
        while j < len(seq) and seq[j] == seq[i]:
            j += 1
        left = j - i
        while left > 0:
            out.append(seq[i])
            k = min(left - 1, max_reps)
            if k:
                out.append(alphabet + k - 1)
            left -= 1 + k
        i = j
    return out


def targets(labels, alphabet: int, max_reps: int, s_pad: int) -> tuple:
    """(targets (B, s_pad) zero-padded, lengths (B,))."""
    enc = [encode(l, alphabet, max_reps) for l in labels]
    out = np.zeros((len(enc), s_pad), np.int64)
    for b, e in enumerate(enc):
        out[b, :len(e)] = e
    return out, np.array([len(e) for e in enc], np.int64)


def collapse(path, alphabet: int, max_reps: int) -> list:
    """Hypothesis of a framewise path: padding (-1) dropped, runs merged, a
    repeat label ``alphabet + k - 1`` read as k more copies of the label
    before it."""
    out, prev = [], None
    for lab in np.asarray(path).tolist():
        if lab < 0 or lab == prev:
            continue
        prev = lab
        if alphabet <= lab < alphabet + max_reps:
            if out:
                out += [out[-1]] * (lab - alphabet + 1)
        else:
            out.append(lab)
    return out
