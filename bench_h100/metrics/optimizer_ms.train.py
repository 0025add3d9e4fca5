"""optimizer_ms.train: device ms a step under AdamW's step, on the first card."""

OPS = ("Optimizer.step#AdamW.step",)


def read(out):
    steps = out.facts.get("steps")
    if not out.traces or not steps:
        return None
    ns = out.traces[0].device_ns(OPS)
    return ns / 1e6 / steps if ns else None
