"""The outward part of a run: the cell's files, the pinned process
settings, the comparison with the limits, and the result line.

A cell is found by its name in ``BENCHMARK.json``: its configuration file,
``traffic/<traffic>.json`` (whose ``loop`` names a module of ``loops/``),
``limits/<workload>.json`` (each number compared and its limit), and a
reader a per-layer metric: ``metrics/<name>.py``, or for ``<quantity>.<cells>``
without a file of its own, the quantity's ``metrics/<quantity>.py``.  Adding a cell, a mix or a
metric adds files and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "torch_asg_tpu")
THREADS = 4
GIB = 2.0 ** 30


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` and the arguments of its run."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int
    seconds: float
    trace: bool
    device: object = None
    started: float = field(default_factory=time.time)


@dataclass
class Outcome:
    """What a loop hands back: end-to-end values, counts, the numbers it
    compared (by name), the device's peak, diagnostics, and for a traced
    run the trace and the facts the readers need."""

    end_to_end: dict
    attempted: int
    failed: int
    numbers: dict
    memory_peak_bytes: int
    count: int
    diagnostics: dict
    traces: list = field(default_factory=list)
    facts: dict = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, seed: int, seconds: float, trace: bool) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files read."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return Cell(name=name, chips=cell["chips"],
                config=load_json(ROOT / config["file"]),
                traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, seed=seed, seconds=seconds, trace=trace)


def pin_settings(torch) -> None:
    """The per-process choices every run makes alike: TF32 off, cuDNN's
    autotuner off (heuristics pick each convolution's algorithm, the same
    in every run), and a fixed number of host threads."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.set_num_threads(THREADS)


def loop(kind: str):
    return importlib.import_module(f"bench_h100.loops.{kind}")


def reader(name: str):
    """The module ``metrics/<name>.py`` (names may hold dots), else the
    quantity's ``metrics/<quantity>.py``, the quantity being the name up to
    its first dot."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smi() -> dict:
    """The card's name, clocks, power draw and limit, and temperature,
    from ``nvidia-smi`` (one row a card)."""
    q = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)}
    return {"query": q, "rows": [r.strip() for r in out.splitlines() if r.strip()]}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def compare(numbers: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for each limit; a number that is missing
    or not finite fails."""
    out = []
    for name, spec in limits.items():
        value = numbers.get(name, float("inf"))
        value = float(value) if value is not None else float("inf")
        ok = value == value and value <= spec["limit"]
        out.append((name, value, spec["limit"], ok))
    return out


def device_info(torch, device, count: int, peak: int, traces) -> dict:
    if getattr(device, "type", device) == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    else:
        info = {"platform": "cpu", "kind": "cpu"}
    info.update(count=count, memory_peak_bytes=int(peak))
    if traces:
        info["busy_s"] = sum(t.busy_ns for t in traces) / len(traces) / 1e9
        info["window_s"] = traces[0].window_ns / 1e9
    return info


def run_cell(cell: Cell) -> dict:
    """Run the cell once; returns the result line as a dict (``checks``
    last)."""
    import torch

    pin_settings(torch)
    out = loop(cell.traffic["loop"]).run(cell)
    checks = compare(out.numbers, cell.limits)
    metrics = {}
    if cell.trace:
        for m in cell.per_layer:
            value = reader(m["name"]).read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    line = {"correct": all(ok for *_, ok in checks) and out.failed == 0,
            "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device_info(torch, cell.device, out.count, out.memory_peak_bytes,
                                  out.traces)}
    if out.traces:
        line["breakdown"] = out.traces[0].breakdown()
    line["diagnostics"] = out.diagnostics
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in checks}
    return line


def setup_done(cell: Cell) -> float:
    """Seconds from the process's start to now: the run's set-up."""
    return time.time() - cell.started


def peak_gib(peak: int) -> float:
    return peak / GIB


def quiet_env() -> None:
    """The host thread count every run fixes before importing a library."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
