"""Host-side data path: a native library with NumPy twins.

Training batches go ``cmvn`` -> ``pack_frames`` -> ``encode_targets`` (as
``examples/train_asg.py::prepare_batch`` prepares them); serving turns a
framewise label path (a column of ``viterbi_decode``'s output) into a label
sequence with ``collapse_path``.

Each of these four takes ``use_native``: ``None`` runs the native library
(``csrc/asg_host.cpp``: C++ with OpenMP, called through ctypes, which
releases the GIL) when it builds and loads, and the NumPy arm otherwise;
``False`` runs the NumPy arm; ``True`` runs the native library and raises
when it cannot be built or loaded.  Both arms give the same arrays, but for
``cmvn``'s rounding (float64 statistics in both; the native arm's
``(x - mean) * scale`` against NumPy's ``(x - mean) / sqrt(var + eps)``).

The library is built with g++ at the first native call, never at import,
into ``build/`` beside this file.  Its file name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded; each build writes a file of its own process and moves it into
place with ``os.replace``, so processes that build at once do not clash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.profiling import span

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "asg_host.cpp"
BUILD = _HERE / "build"
# no -march=native: a cached library must not depend on the CPU that built it
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-std=c++17", "-shared")

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[Exception] = None  # why the library could not be built or loaded


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"asg_host-{digest.hexdigest()[:12]}.so"


def _build() -> Path:
    """The library's path, compiled first if it is missing."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {run.returncode}):\n{run.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32, i32, i64 = ctypes.c_float, ctypes.c_int32, ctypes.c_int64
    p = ctypes.POINTER
    lib.asg_pack_frames.argtypes = [p(f32), p(i64), i64, i64, i64, f32, p(f32), p(i32)]
    lib.asg_pack_frames.restype = None
    lib.asg_encode_batch.argtypes = [p(i32), p(i64), i64, i32, i32, i64, i32, p(i32), p(i32)]
    lib.asg_encode_batch.restype = i64
    lib.asg_collapse_path.argtypes = [p(i32), i64, i32, i32, p(i32)]
    lib.asg_collapse_path.restype = i64
    lib.asg_cmvn.argtypes = [p(f32), p(i64), i64, i64, f32, i32]
    lib.asg_cmvn.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (the reason stays in ``_lib_error``).  Tried once a
    process."""
    global _lib, _lib_error
    with _LOCK:
        if _lib is None and _lib_error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                _lib_error = exc
        return _lib


def has_native_runtime() -> bool:
    return _load() is not None


def _native(use_native: Optional[bool]) -> Optional[ctypes.CDLL]:
    """The library when this call takes the native arm, else None."""
    if use_native is False:
        return None
    lib = _load()
    if lib is None and use_native:
        raise RuntimeError(
            f"use_native=True, but the native host library could not be built or "
            f"loaded: {_lib_error}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _offsets(lengths) -> np.ndarray:
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return offsets


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
         norm_var: bool = True, use_native: Optional[bool] = None) -> list:
    """Per-utterance cepstral mean (and variance) normalisation: new (T_b, F)
    float32 arrays, the inputs untouched.  Statistics are taken in float64."""
    num_batches = len(utterances)
    if num_batches == 0:
        return []
    _check_utterances(utterances)
    lib = _native(use_native)
    if lib is not None:
        offsets = _offsets([u.shape[0] for u in utterances])
        flat = np.ascontiguousarray(
            np.concatenate([np.asarray(u, np.float32) for u in utterances], axis=0),
            np.float32)
        lib.asg_cmvn(_ptr(flat, ctypes.c_float), _ptr(offsets, ctypes.c_int64),
                     num_batches, flat.shape[1], epsilon, 1 if norm_var else 0)
        return [flat[offsets[b]: offsets[b + 1]].copy() for b in range(num_batches)]
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


def pack_frames(utterances: Sequence[np.ndarray], pad_value: float = 0.0,
                use_native: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Pack ragged (T_b, F) utterances into (T_max, B, F) float32 + int32
    lengths."""
    num_batches = len(utterances)
    if num_batches == 0:
        return np.zeros((0, 0, 0), np.float32), np.zeros((0,), np.int32)
    _check_utterances(utterances)
    lengths = np.array([u.shape[0] for u in utterances], np.int32)
    t_max, feat_dim = int(lengths.max()), utterances[0].shape[1]
    lib = _native(use_native)
    if lib is not None:
        frames = np.ascontiguousarray(
            np.concatenate([np.asarray(u, np.float32) for u in utterances], axis=0),
            np.float32)
        out = np.empty((t_max, num_batches, feat_dim), np.float32)
        out_lengths = np.empty(num_batches, np.int32)
        lib.asg_pack_frames(_ptr(frames, ctypes.c_float),
                            _ptr(_offsets(lengths), ctypes.c_int64), num_batches, t_max,
                            feat_dim, pad_value, _ptr(out, ctypes.c_float),
                            _ptr(out_lengths, ctypes.c_int32))
        return out, out_lengths
    out = np.full((t_max, num_batches, feat_dim), pad_value, np.float32)
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
                   max_reps: int = 2, pad_value: int = 0,
                   use_native: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Batch-encode label sequences into the ASG extended alphabet (size
    ``alphabet_size + max_reps``): (targets (B, S_max) int32, target_lengths
    (B,) int32), S_max at least 1."""
    num_batches = len(sequences)
    if num_batches == 0:
        return np.zeros((0, 1), np.int32), np.zeros((0,), np.int32)
    in_lengths = np.array([len(s) for s in sequences], np.int64)
    s_max = int(in_lengths.max())
    lib = _native(use_native)
    if lib is not None and s_max > 0:
        flat = np.ascontiguousarray(
            np.concatenate([np.asarray(s, np.int32) for s in sequences]), np.int32)
        out = np.empty((num_batches, s_max), np.int32)
        out_lengths = np.empty(num_batches, np.int32)
        max_len = lib.asg_encode_batch(_ptr(flat, ctypes.c_int32),
                                       _ptr(_offsets(in_lengths), ctypes.c_int64),
                                       num_batches, alphabet_size, max_reps, s_max,
                                       pad_value, _ptr(out, ctypes.c_int32),
                                       _ptr(out_lengths, ctypes.c_int32))
        return out[:, : max(int(max_len), 1)], out_lengths
    encoded = [encode_labels_np(s, alphabet_size, max_reps) for s in sequences]
    lengths = np.array([len(e) for e in encoded], np.int32)
    out = np.full((num_batches, max(int(lengths.max()), 1)), pad_value, np.int32)
    for b, e in enumerate(encoded):
        out[b, : len(e)] = e
    return out, lengths


def collapse_path(path, alphabet_size: int = 0, max_reps: int = 2,
                  use_native: Optional[bool] = None) -> np.ndarray:
    """Drop -1 padding, merge runs of one label, and, when
    ``alphabet_size > 0``, expand the ``max_reps`` repeat symbols of the ASG
    extended alphabet (labels ``alphabet_size .. alphabet_size + max_reps - 1``
    stand for 1 .. max_reps repeats of the previous label).  With
    ``alphabet_size == 0`` it is a plain merge and ``max_reps`` is ignored.
    ``path`` may be a NumPy array or a tensor on any device.  Under a
    profiler the call is the span ``asg.collapse``, and a tensor's copy to
    the host ``asg.host_sync`` within it."""
    with span("asg.collapse"):
        if hasattr(path, "detach"):
            with span("asg.host_sync"):
                path = path.detach().cpu().numpy()
        path = np.ascontiguousarray(np.asarray(path, np.int32))
        lib = _native(use_native)
        if lib is not None:
            # at worst every frame expands to max_reps + 1 labels
            out = np.empty(path.shape[0] * (max(max_reps, 0) + 1) + 1, np.int32)
            n = lib.asg_collapse_path(_ptr(path, ctypes.c_int32), path.shape[0],
                                      alphabet_size, max_reps, _ptr(out, ctypes.c_int32))
            return out[:n].copy()
        out = []
        prev = -1
        for lab in path.tolist():
            if lab < 0 or lab == prev:
                continue
            prev = lab
            if alphabet_size > 0 and alphabet_size <= lab < alphabet_size + max_reps:
                if out:
                    out.extend([out[-1]] * (lab - alphabet_size + 1))
            else:
                out.append(lab)
        return np.asarray(out, np.int32)
