"""The port's ``trace`` (``utils/profiling.py``), twin of the JAX
package's: it writes a trace only when given a directory."""

import os

import torch

from torch_asg_tpu_torch.utils.profiling import trace


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

