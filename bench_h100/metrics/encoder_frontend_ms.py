"""encoder_frontend_ms (``.train``, ``.serve``): device ms a step or request
under the program's ``asg.encoder.frontend`` span and its ``.backward``:
the strided front end (``blocks[0]``), forward and backward."""

from bench_h100 import spans

SPANS = ("asg.encoder.frontend", "asg.encoder.frontend.backward")


def read(out):
    return spans.device_ms(out, SPANS)
