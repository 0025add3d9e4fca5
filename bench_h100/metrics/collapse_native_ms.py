"""collapse_native_ms (``.serve``): host ms a request in the program's
``asg.collapse`` spans, one a ``collapse_path`` call, without the
benchmark's copy of the paths to the host."""

from bench_h100 import spans


def read(out):
    return spans.host_ms(out, "asg.collapse")
