"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract on names, keys and bounds."""

import json
import re

import pytest

from bench_h100 import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.load_cell(name, seed=1, seconds=1, trace=False)
    assert harness.loop(cell.traffic["loop"]).run
    for m in cell.per_layer:
        assert harness.reader(m["name"]).read
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    assert cell.config["tf32"] is False and cell.config["dtype"] == "float32"


def test_contract_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert not any(p.endswith("_torch") for p in SPEC["paths"])
    names = [c["name"] for c in SPEC["configs"]] + CELLS
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
    assert all(len(w["why"]) <= 200 for w in SPEC["workloads"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = set()
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        layers.add(m["layer"])
    for c in SPEC["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_reader_serves_its_quantity_in_every_cell():
    assert harness.reader("device_idle_pct.train").__file__.endswith("device_idle_pct.py")
    assert harness.reader("device_idle_pct.serve").__file__.endswith("device_idle_pct.py")
    assert harness.reader("encoder_ms.serve").__file__.endswith("encoder_ms.serve.py")


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in SPEC["per_layer"]:
        for w in m["workloads"]:
            cell = harness.load_cell(w, seed=1, seconds=1, trace=False)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
