"""Traffic: raw utterances and transcripts drawn from the seed, and the
port's host path that turns them into the batches the card runs.

One generator serves every mix; a traffic file gives its parameters:
``batch`` utterances a batch, ``pool`` batches, ``feature_frames`` [lo, hi]
(10 ms frames), ``pad_frames``, and for training ``units_per_second``
(letters a second of audio), ``units_jitter`` (the +-share
an utterance) and ``pad_targets``.

Every seed gets the same work.  Each batch's lengths are one stratified
draw over [lo, hi]: the midpoints of ``batch`` equal strata, in an order
the seed sets.  So every batch of every seed holds the same frames, and a
rate does not move with the seed; the seed sets the features, the
transcripts and the order.  Features are normal with an offset and a scale
of their own an utterance, as unnormalised filterbanks have.
"""

from __future__ import annotations

import numpy as np

from . import seeds


def lengths(traffic: dict) -> np.ndarray:
    """The stratified lengths every batch holds (ascending)."""
    lo, hi = traffic["feature_frames"]
    b = traffic["batch"]
    return np.rint(lo + (np.arange(b) + 0.5) * (hi - lo) / b).astype(np.int64)


def raw_batch(traffic: dict, config: dict, seed: int, index: int):
    """(utterances, transcripts) of batch ``index``: float32 (T_b, F) arrays
    and int label arrays (None for traffic without transcripts)."""
    rng = seeds.rng(seed, seeds.UTTERANCES, index)
    feats = config["model"]["in_features"]
    lens = rng.permutation(lengths(traffic))
    total = int(lens.sum())
    loc = rng.normal(size=(len(lens), feats))
    scale = rng.uniform(0.5, 2.0, size=(len(lens), feats))
    flat = rng.standard_normal(size=(total, feats), dtype=np.float32)
    utts, at = [], 0
    for b, n in enumerate(lens):
        utts.append(flat[at:at + n] * scale[b].astype(np.float32) + loc[b].astype(np.float32))
        at += n
    if "units_per_second" not in traffic:
        return utts, None
    secs = lens / config["feature_rate_hz"]
    jitter = traffic["units_jitter"] * rng.uniform(-1.0, 1.0, size=len(lens))
    counts = np.maximum(np.rint(traffic["units_per_second"] * secs * (1.0 + jitter)), 1)
    labels = [rng.integers(0, config["alphabet_size"], size=int(c)) for c in counts]
    return utts, labels


def host_prep(utts, labels, config: dict, traffic: dict) -> dict:
    """The port's host path (``runtime/host.py``, native arm): ``cmvn`` ->
    ``pack_frames`` -> ``encode_targets``, padded to the traffic's
    ``pad_frames`` and ``pad_targets``; NumPy arrays, features (B, T, F)."""
    from torch_asg_tpu_torch.runtime import host

    packed, feat_lengths = host.pack_frames(host.cmvn(utts, use_native=True), use_native=True)
    t_pad = traffic["pad_frames"]
    if packed.shape[0] > t_pad:
        raise ValueError(f"utterance of {packed.shape[0]} frames past pad_frames {t_pad}")
    feats = np.zeros((len(utts), t_pad, packed.shape[2]), np.float32)
    feats[:, :packed.shape[0]] = packed.transpose(1, 0, 2)
    out = {"features": feats, "feature_lengths": feat_lengths.astype(np.int32)}
    if labels is not None:
        enc, enc_lengths = host.encode_targets(labels, config["alphabet_size"],
                                               config["max_reps"], use_native=True)
        s_pad = traffic["pad_targets"]
        if enc.shape[1] > s_pad:
            raise ValueError(f"transcript of {enc.shape[1]} labels past pad_targets {s_pad}")
        targets = np.zeros((len(utts), s_pad), np.int32)
        targets[:, :enc.shape[1]] = enc
        out["targets"] = targets
        out["target_lengths"] = enc_lengths.astype(np.int32)
    return out


def pool(traffic: dict, config: dict, seed: int, device) -> list:
    """The traffic's pool of batches, prepared on the host and resident on
    ``device``: a list of {name: tensor}."""
    import torch

    out = []
    for i in range(traffic["pool"]):
        utts, labels = raw_batch(traffic, config, seed, i)
        host = host_prep(utts, labels, config, traffic)
        out.append({k: torch.as_tensor(v).to(device) for k, v in host.items()})
    return out


def emission_frames(traffic: dict, config: dict) -> int:
    """Unpadded emission frames of one batch (every batch holds the same)."""
    stride = config["model"]["frontend_stride"]
    return int(sum(-(-int(n) // stride) for n in lengths(traffic)))
