"""criterion_host_ms (``.train``): host ms a step in the program's
``asg.criterion`` spans, less their ``asg.host_sync`` spans: the
criterion's Python and launches, which the card, drained by the sync,
waits on."""

from bench_h100 import spans


def read(out):
    n = spans.units(out)
    if not n:
        return None
    trace = out.traces[0]
    crit = spans.inside(trace, "asg.criterion")
    if not crit:
        return None
    syncs = [(s, t) for s, t in spans.inside(trace, "asg.host_sync")
             if any(a <= s and t <= b for a, b in crit)]
    ns = sum(t - s for s, t in crit) - sum(t - s for s, t in syncs)
    return ns / 1e6 / n
