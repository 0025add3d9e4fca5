"""The program's own spans (``torch_asg_tpu_torch/utils/profiling.py``) as
the per-layer readers take them: device time under a span, host time in
spans, and spans counted, each a step or a request of the traced window.

Every reading is None for a run whose trace holds no device work (a run on
the CPU, where no card waits on the host) and for a program that opens
none of the spans read (a program older than them).
"""

from __future__ import annotations


def units(out):
    """Steps or requests of the traced window, or None where nothing is
    read (module docstring)."""
    if not out.traces or not out.traces[0].busy_ns:
        return None
    return out.facts.get("steps") or out.facts.get("requests")


def inside(trace, name: str) -> list:
    """[(start, end)] of the spans ``name`` that lie in the window."""
    return [(s, t) for s, t in trace.spans.get(name, ()) if s >= trace.start and t <= trace.end]


def device_ms(out, names):
    """Device ms a unit of the operations launched inside a span in ``names``."""
    n = units(out)
    ns = out.traces[0].device_ns(names) if n else 0
    return ns / 1e6 / n if ns else None


def host_ms(out, name: str):
    """Host ms a unit inside the spans ``name``."""
    n = units(out)
    ns = out.traces[0].host_ns(name) if n else 0
    return ns / 1e6 / n if ns else None
