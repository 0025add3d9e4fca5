"""encoder_mid_ms (``.train``, ``.serve``): device ms a step or request
under the program's ``asg.encoder.mid`` span and its ``.backward``:
the stride-1 mid stack (``blocks[1:-1]``), forward and backward."""

from bench_h100 import spans

SPANS = ("asg.encoder.mid", "asg.encoder.mid.backward")


def read(out):
    return spans.device_ms(out, SPANS)
