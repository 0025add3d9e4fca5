"""Run one cell of BENCHMARK.json once on the card(s) of this machine.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints diagnostics, then as the last line of standard output one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``; ``checks`` last), and as the last lines
of standard error each number compared beside its limit.  Exits non-zero
and prints no result when CUDA is missing, when the cell asks for more
cards than there are, or when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_h100 import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.quiet_env()
    cell = harness.load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    cell.started = STARTED
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell.chips} CUDA device(s); this machine has {count}",
              file=sys.stderr)
        return 2
    cell.device = torch.device("cuda", 0)
    line = harness.run_cell(cell)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps({"diagnostics": line.pop("diagnostics")}), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
