"""encoder_ms.train: device ms a step of the convolutions, forward and
backward (cuDNN's kernels with their layout transposes), on the first card."""

OPS = ("aten::convolution", "aten::convolution_backward")


def read(out):
    steps = out.facts.get("steps")
    if not out.traces or not steps:
        return None
    ns = out.traces[0].device_ns(OPS)
    return ns / 1e6 / steps if ns else None
