"""viterbi_decode_ms (``.serve``): device ms a request under the program's
``asg.decode`` span, ``viterbi_decode``'s kernels."""

from bench_h100 import spans


def read(out):
    return spans.device_ms(out, ("asg.decode",))
