"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/``), computed after the window
from the seed alone.

Training (the first three steps of the object the window then drives):
  * ``loss_gap``: the widest relative gap of a step's loss, and
    ``first_loss_gap`` the first step's, which AdamW's sign-like first
    update has not yet touched;
  * ``grad_norm_gap``: the first gradient as the optimizer got it (AdamW's
    first moment after one step, over 1 - beta1), by the worst leaf: the
    gap between the program's norm and the reference's, over the larger of
    the reference's norm of that leaf and of the median leaf;
  * ``change_norm_gap``: the same of each leaf's change over the three
    steps, leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's (they move by round-off alone);
  * ``grad_gap_median_leaf``: the median leaf's gradient gap, steadier
    from seed to seed than the worst leaf's.
Serving (a sample of the requests the window finished, drawn from the seed):
  * ``score_gap``: the widest relative gap between a served path's score
    and the reference's best path score;
  * ``path_score_gap``: the widest relative gap between a served path's
    score and that path's score under the reference (an altered path, or
    a score that is not its path's, shows here; a path that scores below
    the best shows in one of the two gaps);
  * ``answer_errors``: hypotheses unequal to the reference's collapse of
    the served path, and paths that are not -1 exactly past each length or
    hold a label outside [0, N); an exact comparison.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from . import data, seeds, weights
from .reference import model as ref
from .reference import prep

INF = float("inf")
ROWS = 64  # the reference's rows a block


def _finite(x: float) -> float:
    return x if np.isfinite(x) else INF


def leaf_gaps(prog: dict, want: dict, keys) -> dict:
    """{leaf: the gap between the program's norm and the reference's, over
    the larger of the reference's norm of that leaf and of the median
    leaf}."""
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    return {k: _finite(abs(prog.get(k, INF) - want[k]) / max(want[k], med, 1e-300))
            for k in keys}


def train_numbers(prog: dict, want: dict) -> tuple:
    """(numbers, worst leaves) of a training cell from the program's
    readings and the reference's: each {'loss': [3], 'grad': {leaf: norm},
    'change': {leaf: norm}}."""
    gaps = [abs(p - w) / abs(w) for p, w in zip(prog["loss"], want["loss"])]
    med = statistics.median(want["grad"].values())
    moved = [k for k, g in want["grad"].items() if g >= 1e-3 * med]
    grad = leaf_gaps(prog["grad"], want["grad"], want["grad"])
    change = leaf_gaps(prog["change"], want["change"], moved)
    return ({"loss_gap": _finite(max(gaps)), "first_loss_gap": _finite(gaps[0]),
             "grad_norm_gap": max(grad.values()),
             "grad_gap_median_leaf": statistics.median(grad.values()),
             "change_norm_gap": max(change.values())},
            {"grad_norm_gap": max(grad, key=grad.get),
             "change_norm_gap": max(change, key=change.get),
             "left_out_of_change": sorted(set(want["grad"]) - set(moved))})


def ref_batch(cfg: dict, trf: dict, seed: int, index: int, device, dtype):
    """One batch prepared by the reference from the raw draw."""
    utts, labels = data.raw_batch(trf, cfg, seed, index)
    feats, fl = prep.pack(utts, trf["pad_frames"])
    out = [torch.as_tensor(feats, dtype=dtype, device=device),
           torch.as_tensor(fl, device=device)]
    if labels is not None:
        tg, tl = prep.targets(labels, cfg["alphabet_size"], cfg["max_reps"], trf["pad_targets"])
        out += [torch.as_tensor(tg, device=device), torch.as_tensor(tl, device=device)]
    return out


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def reference_train(cfg: dict, trf: dict, seed: int, device) -> dict:
    """The reference's first three steps from the benchmark's weights, each
    on the rows of the batch of that index, in blocks of at most ``ROWS``
    rows."""
    dtype = torch.float64
    w = weights.make(cfg, seed, device)
    params = {k: v.to(dtype) for k, v in w.items()}
    del w
    start = {k: v.clone() for k, v in params.items()}
    opt = ref.AdamW(params, **cfg["optimizer"])
    out = {"loss": []}
    for i in range(3):
        whole = ref_batch(cfg, trf, seed, i, device, dtype)
        blocks = [[t[r:r + ROWS] for t in whole] for r in range(0, whole[0].shape[0], ROWS)]
        loss, grads = ref.loss_and_grads(params, blocks, cfg["model"])
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = norms(grads)
        opt.step(grads)
    out["change"] = norms({k: params[k] - start[k] for k in params})
    return out


def serve_numbers(cfg: dict, trf: dict, seed: int, device, served: list) -> dict:
    """The serving numbers over ``served``: [(pool index, paths (T', B),
    scores (B,), hypotheses)] of the sampled requests."""
    dtype = torch.float64
    w = weights.make(cfg, seed, device, transition_scale=trf["transition_scale"])
    params = {k: v.to(dtype) for k, v in w.items()}
    del w
    n, stride = cfg["model"]["num_labels"], cfg["model"]["frontend_stride"]
    score_gap = path_gap = 0.0
    errors = 0
    for index, paths, scores, hyps in served:
        feats, fl = ref_batch(cfg, trf, seed, index, device, dtype)
        with torch.no_grad():
            em = ref.encoder(params, feats, cfg["model"])
        li = ref.output_length(fl, stride)
        best = ref.viterbi_best(params["transition"], em, li)
        p = torch.as_tensor(paths, device=device)
        got = ref.path_score(params["transition"], em, li, p)
        s = torch.as_tensor(scores, dtype=dtype, device=device)
        score_gap = max(score_gap, _finite(float(((s - best).abs() / best.abs()).max())))
        path_gap = max(path_gap, _finite(float(((s - got).abs() / best.abs()).max())))
        t = torch.arange(p.shape[0], device=device)[:, None]
        pad = t >= li[None, :]
        bad = ((p == -1) != pad) | (p >= n) | (p < -1)
        errors += int(bad.any(0).sum())
        for b in range(p.shape[1]):
            want = prep.collapse(paths[:, b], cfg["alphabet_size"], cfg["max_reps"])
            errors += int(list(np.asarray(hyps[b]).tolist()) != want)
    return {"score_gap": score_gap, "path_score_gap": path_gap, "answer_errors": errors}


def sample(seed: int, completed: int, size: int) -> list:
    """Indices of the finished requests to check, drawn from the seed."""
    rng = seeds.rng(seed, seeds.SAMPLE)
    return sorted(rng.choice(completed, size=min(size, completed), replace=False).tolist())
