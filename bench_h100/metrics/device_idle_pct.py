"""device_idle_pct (``.train``, ``.serve``): 100 (1 - busy / window) over
the traced window, averaged over the cards."""


def read(out):
    if not out.traces or not all(t.busy_ns for t in out.traces):
        return None
    return 100.0 * sum(1.0 - t.busy_ns / t.window_ns for t in out.traces) / len(out.traces)
