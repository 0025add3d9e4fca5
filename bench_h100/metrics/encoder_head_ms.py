"""encoder_head_ms (``.glu``): device ms a step under the program's
``asg.encoder.head`` span and its ``.backward``: the gated ConvNet's two
linear layers (the hidden GLU layer and the emissions), forward and
backward."""

from bench_h100 import spans

SPANS = ("asg.encoder.head", "asg.encoder.head.backward")


def read(out):
    return spans.device_ms(out, SPANS)
