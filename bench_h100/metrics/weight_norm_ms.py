"""weight_norm_ms (``.glu``): device ms a step under the program's
``asg.weight_norm`` span and its ``.backward``: every layer's weight made
from its (v, g) pair, and the gradients taken back to v and g."""

from bench_h100 import spans

SPANS = ("asg.weight_norm", "asg.weight_norm.backward")


def read(out):
    return spans.device_ms(out, SPANS)
