"""step_mfu.train: the model's float32 operations of the window's steps
(``work.py``: convolutions and head forward and backward at the padded
shapes, plus the criterion's counted operations) over the traced window's
seconds, against the float32 peak of every card used, in percent."""

from bench_h100 import work


def read(out):
    flops, secs = out.facts.get("model_flops"), out.facts.get("window_s")
    if not out.traces or not flops or not secs or not all(t.busy_ns for t in out.traces):
        return None
    return 100.0 * flops / secs / (work.FP32_FLOPS * out.count)
