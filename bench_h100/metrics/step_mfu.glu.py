"""step_mfu.glu: the gated ConvNet's float32 operations of the window's
steps (``work_glu.encoder_flops``: convolutions and linear layers forward
and backward at the padded shapes, plus ``work.criterion_work``'s count)
over the traced window's seconds, against the float32 peak of the card,
in percent; read as ``step_mfu.train`` reads Wav2Letter's."""

from bench_h100 import harness


def read(out):
    return harness.reader("step_mfu.train").read(out)
