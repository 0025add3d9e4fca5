"""The ``native_convs`` readers on a made-up traced window: ``asg.conv``
spans over device work read their count a step or a request, and a window
without one reads None, as the program before the hand-written convolution
gives."""

import pytest

from bench_h100 import harness, trace

from .test_bench_spans import Row, profile_of, without_program_spans


def conv_window(per_unit, units):
    """A window of ``units`` steps or requests, each with ``per_unit``
    ``asg.conv`` spans, each over a kernel it launched."""
    rows, corr = [Row("bench.window", 0, 10 ** 6, False, 1, 1)], 2
    for u in range(units):
        start = 1000 + u * 10 ** 5
        for i in range(per_unit):
            s = start + i * 1000
            rows.append(Row("asg.conv", s, s + 500, False, 1, corr))
            rows.append(Row("aten::empty", s + 10, s + 20, False, 1, corr + 1))
            rows.append(Row("conv_unfold_kernel", s + 30, s + 900, True, 0, 10 ** 6 + corr,
                            corr + 1))
            corr += 2
    return trace.Trace(profile_of(rows))


def outcome(traces, units):
    return harness.Outcome(end_to_end={}, attempted=3, failed=0, numbers={},
                           memory_peak_bytes=0, count=1, diagnostics={}, traces=traces,
                           facts={units: 3, "window_s": 1.0})


@pytest.mark.parametrize("name,units", [("native_convs.train", "steps"),
                                        ("native_convs.serve", "requests")])
def test_eight_conv_spans_a_unit_read_eight(name, units):
    assert harness.reader(name).read(outcome([conv_window(8, 3)], units)) == 8.0


@pytest.mark.parametrize("name,units", [("native_convs.train", "steps"),
                                        ("native_convs.serve", "requests")])
def test_no_conv_span_reads_none(name, units):
    read = harness.reader(name).read
    assert read(outcome([without_program_spans()], units)) is None
    assert read(outcome([], units)) is None
