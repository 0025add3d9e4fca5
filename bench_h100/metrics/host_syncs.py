"""host_syncs (``.train``): ``asg.host_sync`` spans a step, each a place
where the program blocks the host on the device (the criterion's spread
guard); counted where the program opens ``asg.criterion`` spans, so that a
program without syncs reads 0."""

from bench_h100 import spans


def read(out):
    n = spans.units(out)
    if not n or not spans.inside(out.traces[0], "asg.criterion"):
        return None
    return len(spans.inside(out.traces[0], "asg.host_sync")) / n
