"""encoder_fwd_ms (``.train``, ``.serve``): device ms a step or request
under the program's ``asg.encoder`` span, the encoder's forward: its
blocks and the head projection."""

from bench_h100 import spans


def read(out):
    return spans.device_ms(out, ("asg.encoder",))
