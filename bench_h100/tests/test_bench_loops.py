"""The loops at a tiny size on the CPU: the program's path agrees with the
reference, the training window holds no host preparation and no copy to
the device, the process settings are pinned, and the trace reduction ties
device work to the host ops that launched it."""

import types

import pytest
import torch

from bench_h100 import data, harness, trace
from bench_h100.loops import common

from . import tiny


def test_train_window_holds_only_steps(monkeypatch):
    from torch_asg_tpu_torch.runtime import host

    opened = {"now": False}

    def guard(fn):
        def wrapped(*a, **k):
            if opened["now"]:
                raise AssertionError(f"{fn.__name__} ran inside the window")
            return fn(*a, **k)
        return wrapped

    for name in ("cmvn", "pack_frames", "encode_targets"):
        monkeypatch.setattr(host, name, guard(getattr(host, name)))
    for name in ("pool", "host_prep", "raw_batch"):
        monkeypatch.setattr(data, name, guard(getattr(data, name)))
    enter, leave = common.Window.__enter__, common.Window.__exit__

    def open_window(self):
        opened["now"] = True
        return enter(self)

    def close_window(self, *exc):
        out = leave(self, *exc)
        opened["now"] = False
        return out

    monkeypatch.setattr(common.Window, "__enter__", open_window)
    monkeypatch.setattr(common.Window, "__exit__", close_window)
    torch.backends.cudnn.benchmark = True
    line = harness.run_cell(tiny.cell("letters-train"))
    assert line["correct"] and line["attempted"] >= 1
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.benchmark is False


@pytest.mark.parametrize("name", ["letters-train", "letters-serve"])
def test_program_is_correct_at_a_tiny_size(name):
    line = harness.run_cell(tiny.cell(name, seed=2 ** 32 + 3))
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in
                                    harness.load_cell(name, 1, 1, False).end_to_end}
    assert list(line)[-1] == "checks"


def test_traced_run_reads_host_spans_and_no_device_metric_on_the_cpu():
    line = harness.run_cell(tiny.cell("letters-serve", trace=True))
    assert line["correct"]
    assert set(line["metrics"]) == {"collapse_ms.serve"}
    assert line["device"]["platform"] == "cpu" and line["device"]["window_s"] > 0


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch_asg_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "torch_asg_tpu.fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["torch_asg_tpu.fake"]


class Ev:
    def __init__(self, name, start, end, device, tid=1, corr=0, link=0):
        self._v = (name, start, end, device, tid, corr, link)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def end_ns(self): return self._v[2]
    def device_type(self): return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"
    def start_thread_id(self): return self._v[4]
    def correlation_id(self): return self._v[5]
    def linked_correlation_id(self): return self._v[6]


def test_trace_ties_device_work_to_host_ops():
    events = [
        Ev("bench.window", 0, 1000, False, corr=1),
        Ev("bench.step", 10, 900, False, corr=2),
        Ev("aten::convolution", 20, 100, False, corr=3),
        Ev("cudaLaunchKernel", 30, 40, False, corr=501),
        Ev("conv_kernel", 100, 300, True, corr=501, link=3),
        Ev("_FusedScoresBackward", 200, 400, False, tid=2, corr=4),
        Ev("asg_bwd", 350, 500, True, corr=777, link=4),  # no runtime row: by its link
        Ev("bench.window", 0, 1000, True),  # the span's device side is no work
        Ev("ncclDevKernel_AllReduce", 600, 650, True, corr=900, link=99),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    t = trace.Trace(prof)
    assert t.window_ns == 1000
    assert t.device_ns(("aten::convolution",)) == 200
    assert t.device_ns(("bench.step",)) == 200
    assert t.device_ns(("_FusedScoresBackward",)) == 150
    assert t.device_ns(("no such op",)) == 0
    assert t.busy_ns == 200 + 150 + 50
    assert t.host_ns("bench.step") == 890
    gaps = dict(t.idle)
    assert sum(gaps.values()) == 1000 - 400
    assert t.breakdown()["device_ops"][0] == ["conv_kernel", 200 / 1e9]
