#!/usr/bin/env python3
"""Time the PyTorch port's serving and letter-training paths in two
checkouts on one CUDA card, in turns (A, B, B, A), so that a change is
compared with its parent within one run on one card.

    python3 scripts/ab_serve_train.py PARENT_ROOT CHANGE_ROOT

Each turn is a fresh process started in that checkout's root.  It builds
the checkout's kernels, then runs that checkout's ``chip_smoke.py`` phases
``serve`` (3 requests of 64 utterances after a warm-up) and ``train`` (5
AdamW steps after a warm-up, then the criterion's forward+backward alone),
each on data from ``chip_smoke.SEED``, so both checkouts see the same
inputs.  Prints one JSON line per turn and, last, one line with each
checkout's turns side by side.  Exits nonzero if a turn fails.
"""

import json
import subprocess
import sys

TURN = r"""
import numpy as np, torch
import chip_smoke as c
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
c.train(np.random.default_rng(c.SEED), dev)
"""

KEEP = {
    "serve": ("median_latency_ms", "latency_ms", "stage_ms_first_request"),
    "train": ("median_step_ms", "step_ms", "stage_ms", "criterion_fwd_bwd_ms",
              "criterion_profile"),
}


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
                phases[record["phase"]] = {k: record[k] for k in KEEP[record["phase"]]}
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
        "criterion_device_busy_ms": [t["train"]["criterion_profile"]["device_busy_ms"]
                                     for t in ts],
        "criterion_idle_share": [t["train"]["criterion_profile"]["idle_share"] for t in ts],
        "asg_scores_stage_ms": [t["serve"]["stage_ms_first_request"]["asg_scores"] for t in ts],
        "asg_loss_stage_ms": [t["serve"]["stage_ms_first_request"]["asg_loss"] for t in ts],
    } for label, ts in turns.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
