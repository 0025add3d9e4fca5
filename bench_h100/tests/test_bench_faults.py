"""The control and each planted fault a cell can have come out as not
correct: a run driven whole on the CPU at a tiny size, with the timed path
broken underneath (the chip readings at the cells' own sizes are in
PERF.md)."""

import pytest

from bench_h100 import faults, harness

from . import tiny

CASES = [("letters-train", f) for f in ("control", "unchanged_state", "half_batch")]
CASES += [("letters-serve", f) for f in ("control", "altered_answer")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    cell = tiny.cell(name, seed=2 ** 31 + 77)
    with faults.BY_LOOP[cell.traffic["loop"]][fault]():
        line = harness.run_cell(cell)
    assert line["correct"] is False, line["checks"]
