#!/usr/bin/env python3
"""Time the PyTorch port's serving, alignment and letter-training paths
(training through the fused and through the per-lattice tier) in two
checkouts on one CUDA card,
in turns (A, B, B, A), so that a change is compared with its parent within
one run on one card.

    python3 scripts/ab_serve_train.py PARENT_ROOT CHANGE_ROOT

Each turn is a fresh process started in that checkout's root.  It builds
the checkout's kernels, then runs that checkout's ``chip_smoke.py`` phases
``serve`` (3 requests of 64 utterances after a warm-up), ``train`` (5
AdamW steps after a warm-up, then the criterion's forward+backward alone),
``train_pallas`` (the same, through ``impl='pallas'``),
``serve_posterior`` (3 posterior-decoding requests after a warm-up) and
``align`` (3 forced-alignment requests after a warm-up), each on data from
``chip_smoke.SEED`` (``align``: from a stream of its own), so both
checkouts see the same inputs.  The turn takes no profile.  After it, this
checkout's ``chip_smoke.profile_call`` profiles five calls of that
checkout's port, each in a new process (the letter criterion through each
tier, one per-lattice score-only call, one posterior request, one serving
viterbi_decode call: device busy time, idle share, kernel count),
so that both checkouts are measured alike.  Prints one JSON line per turn
and, last, one line with each checkout's turns side by side.  Exits
nonzero if a turn fails.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as instrument  # noqa: E402  (this checkout's)

TURN = r"""
import numpy as np, torch
import chip_smoke as c
# the profiles are taken after the turn, each in a process of its own
c.device_profile = lambda fn, *names: {"device_busy_ms": float("nan")}
c.profile_call = lambda name, root=None: None
from torch_asg_tpu_torch.ops.kernels import _build
from torch_asg_tpu_torch.ops.kernels.asg_kernels import asg_scores_fused
from torch_asg_tpu_torch.ops.kernels.viterbi_kernels import (
    viterbi_backtrace_pallas, viterbi_forward_pallas)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
dev = torch.device("cuda", 0)
c.serve(np.random.default_rng(c.SEED), dev,
        (asg_scores_fused, viterbi_forward_pallas, viterbi_backtrace_pallas))
_, (utts, labels) = c.train(np.random.default_rng(c.SEED), dev)
rng_pallas = np.random.default_rng([c.SEED, 41])
c.train_pallas(rng_pallas, dev, utts, labels)
c.serve_posterior(rng_pallas, dev)
c.align(np.random.default_rng([c.SEED, 8]), dev)
"""

KEEP = {
    "serve": ("median_latency_ms", "latency_ms", "stage_ms_first_request"),
    "train": ("median_step_ms", "step_ms", "stage_ms", "criterion_fwd_bwd_ms"),
    "train_pallas": ("median_step_ms", "step_ms", "stage_ms", "criterion_fwd_bwd_ms",
                     "scores_only_ms"),
    "serve_posterior": ("median_latency_ms", "latency_ms", "stage_ms_second_request"),
    "align": ("median_latency_ms", "latency_ms"),
}
# the calls profiled after each turn (chip_smoke.PROFILES)
PROFILED = ("train_criterion", "pallas_criterion", "pallas_scores", "posterior_request",
            "serve_decode")
PROFILE_KEYS = ("device_busy_ms", "kernels", "call_ms", "idle_share", "top_kernels_ms")


def turn(root):
    out = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    phases = {}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            record = json.loads(line)
            if record.get("phase") in KEEP:
                phases[record["phase"]] = {k: record.get(k) for k in KEEP[record["phase"]]}
    phases["profiles"] = {}
    for name in PROFILED:
        got = instrument.profile_call(name, root)
        phases["profiles"][name] = {k: got[k] for k in PROFILE_KEYS}
    return phases


def main(argv):
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"parent": argv[1], "change": argv[2]}
    turns = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        phases = turn(roots[label])
        turns[label].append(phases)
        print(json.dumps({"turn": label, **phases}), flush=True)
    print(json.dumps({label: {
        "serve_median_latency_ms": [t["serve"]["median_latency_ms"] for t in ts],
        "train_median_step_ms": [t["train"]["median_step_ms"] for t in ts],
        "criterion_fwd_bwd_ms": [t["train"]["criterion_fwd_bwd_ms"] for t in ts],
        **{f"{name}_{key}": [t["profiles"][name][key] for t in ts]
           for name in PROFILED for key in ("device_busy_ms", "idle_share", "kernels")},
        "asg_scores_stage_ms": [t["serve"]["stage_ms_first_request"]["asg_scores"] for t in ts],
        "asg_loss_stage_ms": [t["serve"]["stage_ms_first_request"]["asg_loss"] for t in ts],
        "viterbi_decode_stage_ms": [t["serve"]["stage_ms_first_request"]["viterbi_decode"]
                                    for t in ts],
        "pallas_median_step_ms": [t["train_pallas"]["median_step_ms"] for t in ts],
        "pallas_criterion_fwd_bwd_ms": [t["train_pallas"]["criterion_fwd_bwd_ms"]
                                        for t in ts],
        "pallas_scores_only_ms": [t["train_pallas"]["scores_only_ms"] for t in ts],
        "posterior_median_latency_ms": [t["serve_posterior"]["median_latency_ms"]
                                        for t in ts],
        "posterior_decode_stage_ms": [
            t["serve_posterior"]["stage_ms_second_request"]["posterior_decode"] for t in ts],
        "align_median_latency_ms": [t["align"]["median_latency_ms"] for t in ts],
    } for label, ts in turns.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
