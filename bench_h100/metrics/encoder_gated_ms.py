"""encoder_gated_ms (``.glu``): device ms a step under the program's
``asg.encoder.gated`` span and its ``.backward``: the gated ConvNet's
convolutions with their GLUs and dropout, forward and backward."""

from bench_h100 import spans

SPANS = ("asg.encoder.gated", "asg.encoder.gated.backward")


def read(out):
    return spans.device_ms(out, SPANS)
