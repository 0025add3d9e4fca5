"""Run one cell in sets of runs, each run a process of its own as a
benchmark check starts it, and summarise each end-to-end metric as the
check judges its bound.

    python3 bench_h100/sets.py --workload <name> --seeds 11,12,13 --seconds 20 \
        [--sets 2] [--trace 0|1] [--out <file>.jsonl]

Every set runs the same seeds.  A spread is a share of the median: the
distance between the first and the third quartile
(``statistics.quantiles(n=4)``).  For each metric and set the summary gives
``spread`` (all the set's runs) and, with the run farthest from the median
left out, ``spread_trimmed`` and ``range_trimmed`` (the rest's widest
distance); across the sets, ``tight_iqr`` and ``tight_range`` (the mean of
the sets' trimmed spreads and ranges: a bound is too tight where one of
them exceeds half of it), ``loose`` (the spread of every run of every set:
a bound is too loose above eight times it), ``widest`` (the wider of the
sets' spreads, five times which sets a bound) and ``median_shift`` (the
last set's median against the first's).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed(values) -> list:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def summary(sets: list) -> dict:
    """{metric: figures} over ``sets``, each a list of result lines."""
    names = sorted({k for s in sets for r in s for k in r["metrics"]})
    out = {}
    for n in names:
        per = [[r["metrics"][n]["value"] for r in s if n in r["metrics"]] for s in sets]
        if min(map(len, per)) < 3:
            continue
        figs = []
        for vals in per:
            rest = trimmed(vals)
            med = statistics.median(vals)
            figs.append({"median": med, "spread": spread(vals), "spread_trimmed": spread(rest),
                         "range_trimmed": (max(rest) - min(rest)) / statistics.median(rest),
                         "values": vals})
        out[n] = {"sets": figs,
                  "tight_iqr": statistics.mean(f["spread_trimmed"] for f in figs),
                  "tight_range": statistics.mean(f["range_trimmed"] for f in figs),
                  "loose": spread([v for vals in per for v in vals]),
                  "widest": max(f["spread"] for f in figs),
                  "median_shift": figs[-1]["median"] / figs[0]["median"] - 1.0}
    return out


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.time()
    proc = subprocess.run([sys.executable, str(RUN), "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)], capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    row = {"workload": workload, "seed": seed, "rc": proc.returncode,
           "wall_s": time.time() - t0, "stderr_tail": proc.stderr[-1500:]}
    try:
        row["result"] = json.loads(lines[-1])
        row["diagnostics"] = json.loads(lines[-2])["diagnostics"] if len(lines) > 1 else None
    except (IndexError, json.JSONDecodeError):
        row["stdout_tail"] = proc.stdout[-1500:]
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        results = []
        for seed in seeds:
            row = run_once(args.workload, seed, args.seconds, args.trace)
            row["set"] = k
            res = row.get("result", {})
            if res:
                results.append(res)
            print(json.dumps({"set": k, "seed": seed, "rc": row["rc"],
                              "wall_s": round(row["wall_s"], 1), "correct": res.get("correct"),
                              "metrics": {n: v["value"] for n, v in res.get("metrics", {}).items()},
                              "checks": {n: v["value"] for n, v in res.get("checks", {}).items()}}),
                  flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
        sets.append(results)
    print(json.dumps({"summary": summary(sets)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
