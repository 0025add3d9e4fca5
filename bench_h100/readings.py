"""Readings that set a cell's limits, read at the cell's own size on the
card, all in one process: the numbers the comparison takes, for the
program on a dozen seeds or more, for the control, and for each planted
fault (``faults.py``).  Each run is a whole run of the cell's loop with a
short window (training's readings need none; serving's one long enough to
answer and compare as many requests as a run checks).

    python3 bench_h100/readings.py --workload <name> --seeds 1,2,3 \
        [--control 4,5,6] [--fault half_batch:7,8,9 ...] [--seconds 1] \
        [--out <file>.jsonl]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_h100 import faults, harness  # noqa: E402


def read(name, seed, seconds, device, plant=None) -> dict:
    import torch

    cell = harness.load_cell(name, seed, seconds, False)
    cell.device = device
    t0 = time.time()
    with plant() if plant else contextlib.nullcontext():
        line = harness.run_cell(cell)
    torch.cuda.empty_cache()
    return {"seed": seed, "correct": line["correct"], "wall_s": time.time() - t0,
            "numbers": {k: v["value"] for k, v in line["checks"].items()},
            "metrics": {k: v["value"] for k, v in line["metrics"].items()},
            "worst_leaves": line["diagnostics"].get("worst_leaves")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.quiet_env()
    import torch

    harness.pin_settings(torch)
    device = torch.device("cuda", 0)
    kind = harness.load_cell(args.workload, 0, 0, False).traffic["loop"]
    jobs = [("program", s, None) for s in args.seeds.split(",") if s]
    jobs += [("control", s, faults.BY_LOOP[kind]["control"]) for s in args.control.split(",") if s]
    for spec in args.fault:
        fault, seeds = spec.split(":")
        jobs += [(fault, s, faults.BY_LOOP[kind][fault]) for s in seeds.split(",")]
    for what, seed, plant in jobs:
        try:
            row = read(args.workload, int(seed), args.seconds, device, plant)
        except Exception as exc:  # a control or fault that crashes has failed: record it
            row = {"seed": int(seed), "error": f"{type(exc).__name__}: {exc}"[:2000]}
        row = {"workload": args.workload, "what": what, **row}
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
