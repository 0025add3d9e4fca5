"""encoder_wide_ms (``.train``, ``.serve``): device ms a step or request
under the program's ``asg.encoder.wide`` span and its ``.backward``:
the wide block (``blocks[-1]``, channels to head channels), forward and backward."""

from bench_h100 import spans

SPANS = ("asg.encoder.wide", "asg.encoder.wide.backward")


def read(out):
    return spans.device_ms(out, SPANS)
