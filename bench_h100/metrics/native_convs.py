"""native_convs (``.train``, ``.serve``): ``asg.conv`` spans a step or a
request, each one forward call of a stride-1 block on the program's
hand-written channels-last convolution; None where the program opens none
(a program without that convolution, or a run on the CPU)."""

from bench_h100 import spans


def read(out):
    n = spans.units(out)
    convs = len(spans.inside(out.traces[0], "asg.conv")) if n else 0
    return convs / n if convs else None
