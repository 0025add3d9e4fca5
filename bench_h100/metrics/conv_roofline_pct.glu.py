"""conv_roofline_pct.glu: the least time of the gated ConvNet's
convolutions, forward, input and weight gradients, at the window's padded
shapes (``work_glu.conv_work``: float32 operations over 67 TFLOP/s against
bytes over 3.35 TB/s, the larger) over the device time of the kernels
launched by the convolution's autograd function, forward (``asg.conv``,
``_ConvBias``) and backward (``_ConvBiasBackward``), in percent; None where
the program launches none (a program without the bias-only convolution)."""

from bench_h100 import spans, work

OPS = ("asg.conv", "_ConvBias", "_ConvBiasBackward")


def read(out):
    if not spans.units(out) or not out.facts.get("conv_ops"):
        return None
    ns = out.traces[0].device_ns(OPS)
    if not ns:
        return None
    least = work.bound_s(out.facts["conv_ops"], out.facts["conv_bytes"])
    return 100.0 * least / (ns / 1e9)
