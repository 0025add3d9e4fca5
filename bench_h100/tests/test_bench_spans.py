"""The readers of the program's spans (``spans.py`` and its metrics) on a
traced run of the tiny cells, with a device row laid under every ``aten::``
op of the CPU profile as if a card had run it: each reads a number where
its spans are there, and None on the CPU's own trace, on an untraced run
and on a trace without the program's spans.  The stages' device time adds
up to at least the convolutions', and each inside twin reads no more than
the benchmark's own span around the same call."""

import types

import pytest

from bench_h100 import harness, trace

from . import tiny

TRAIN = ("encoder_fwd_ms", "encoder_frontend_ms", "encoder_mid_ms", "encoder_wide_ms",
         "host_syncs", "criterion_host_ms")
SERVE = ("encoder_fwd_ms", "encoder_frontend_ms", "encoder_mid_ms", "encoder_wide_ms",
         "viterbi_decode_ms", "collapse_native_ms")
STAGES = ("encoder_frontend_ms", "encoder_mid_ms", "encoder_wide_ms")


class Row:
    """One event of a profile, as ``trace.Trace`` reads it."""

    def __init__(self, name, start, end, device, tid, corr, link=0):
        self._v = (name, start, end, device, tid, corr, link)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def end_ns(self): return self._v[2]
    def device_type(self): return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"
    def start_thread_id(self): return self._v[4]
    def correlation_id(self): return self._v[5]
    def linked_correlation_id(self): return self._v[6]


def profile_of(rows):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: rows)))


def on_a_card(prof):
    """The CPU profile with a device row under each ``aten::`` op, launched
    at the op's start (linked to it) and taking half its time."""
    rows = []
    for i, e in enumerate(prof.profiler.kineto_results.events(), start=1):
        s, t = e.start_ns(), e.end_ns()
        rows.append(Row(e.name(), s, t, False, e.start_thread_id(), i))
        if e.name().startswith("aten::"):
            rows.append(Row("kernel_" + e.name()[6:], s, max(s + 1, (s + t) // 2), True, 0,
                            10 ** 9 + i, i))
    return profile_of(rows)


def traced(monkeypatch, name):
    """The result line of a traced tiny run of the cell, its trace laid on a card."""
    cpu_trace = trace.Trace
    monkeypatch.setattr(trace, "Trace", lambda prof: cpu_trace(on_a_card(prof)))
    line = harness.run_cell(tiny.cell(name, trace=True))
    assert line["correct"]
    return {k: v["value"] for k, v in line["metrics"].items()}


def test_train_readers_read_the_step_spans(monkeypatch):
    got = traced(monkeypatch, "letters-train")
    assert all(got.get(f"{q}.train") for q in TRAIN if q != "host_syncs")
    assert got["host_syncs.train"] == 1.0
    assert sum(got[f"{q}.train"] for q in STAGES) >= got["encoder_ms.train"] > 0


def test_serve_readers_read_the_request_spans(monkeypatch):
    got = traced(monkeypatch, "letters-serve")
    assert all(got.get(f"{q}.serve") for q in SERVE)
    assert sum(got[f"{q}.serve"] for q in STAGES) <= got["encoder_fwd_ms.serve"]
    assert got["encoder_fwd_ms.serve"] <= got["encoder_ms.serve"]
    assert got["viterbi_decode_ms.serve"] <= got["decode_ms.serve"]
    assert got["collapse_native_ms.serve"] <= got["collapse_ms.serve"]


def without_program_spans():
    """A window with device work and none of the program's spans."""
    rows = [Row("bench.window", 0, 1000, False, 1, 1), Row("bench.step", 10, 900, False, 1, 2),
            Row("aten::convolution", 20, 100, False, 1, 3),
            Row("conv_kernel", 100, 300, True, 0, 501, 3)]
    return trace.Trace(profile_of(rows))


@pytest.mark.parametrize("quantity", sorted(set(TRAIN + SERVE)))
@pytest.mark.parametrize("units", ["steps", "requests"])
def test_readers_read_none_without_their_spans(quantity, units):
    read = harness.reader(quantity).read
    facts = {units: 3, "window_s": 1.0}

    def outcome(traces):
        return harness.Outcome(end_to_end={}, attempted=3, failed=0, numbers={},
                               memory_peak_bytes=0, count=1, diagnostics={}, traces=traces,
                               facts=facts)

    assert read(outcome([])) is None
    assert read(outcome([without_program_spans()])) is None


def test_the_cpu_trace_gives_no_reading():
    line = harness.run_cell(tiny.cell("letters-train", trace=True))
    assert line["correct"]
    assert not {f"{q}.train" for q in TRAIN} & set(line["metrics"])
