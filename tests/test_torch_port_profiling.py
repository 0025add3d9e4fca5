"""The port's profiling helpers (``utils/profiling.py``), twins of the JAX
package's: ``trace`` writes a trace only when given a directory, and
``time_fn_chained`` chains each call on the one before, calls the feedback
once a call, and returns a positive time.  On the CPU (no card) the times
are host times and say nothing of the card."""

import os

import pytest
import torch

from torch_asg_tpu_torch.utils.profiling import (fetch_overhead_s, time_fn_chained,
                                                 trace)


def _work():
    x = torch.randn(64, 64)
    return (x @ x).sum()


def test_trace_writes_only_with_a_directory(tmp_path):
    with trace(None):
        _work()
    with trace(""):
        _work()
    assert not any(tmp_path.iterdir())
    out = tmp_path / "trace"
    with trace(str(out)):
        _work()
    (written,) = out.iterdir()
    assert written.name == f"trace-{os.getpid()}.json" and written.stat().st_size > 0


def test_fetch_overhead_is_a_positive_median():
    assert fetch_overhead_s(samples=3, device="cpu") > 0.0


@pytest.mark.parametrize("out_kind", ["tensor", "tuple", "dict"])
def test_time_fn_chained_chains_and_calls_feedback(out_kind):
    seen = []

    def step(x):
        y = x * 1.0001
        return {"tensor": y, "tuple": (y, 1), "dict": {"y": y}}[out_kind]

    def feedback(x0, out):
        y = out if out_kind == "tensor" else out[0] if out_kind == "tuple" else out["y"]
        seen.append(y)
        return x0 + 0.0 * y

    x0 = torch.ones(8)
    s = time_fn_chained(step, feedback, x0, warmup=2, iters=5, fetch_s=0.0)
    assert s > 0.0
    assert len(seen) == 2 + 5  # once a call, warm-up included
    assert all(torch.equal(y, x0 * 1.0001) for y in seen)
    with pytest.raises(TypeError, match="no tensor"):
        time_fn_chained(lambda x: (1, 2), lambda x0, out: x0, x0, iters=1, fetch_s=0.0)
