"""Operations and bytes of the gated ConvNet's encoder
(``configs/conv-glu-librispeech.json``), counted from shapes, as
``work.py`` counts Wav2Letter's.

Each convolution (stride 1, SAME, T frames out) costs 2 B T C_out C_in K
float32 operations forward, as many for its weight gradient, and as many
for its input gradient except the first layer's (the features need
none); the two linear layers likewise (the hidden one's input gradient
is needed).  Biases, GLUs, dropout, weight normalisation and the
criterion are left out here (``work.criterion_work`` counts the
criterion); nothing recomputed is counted.  Bytes, a pass: its inputs
read once and its output written once, 4 bytes an element (forward: the
input, the weight, the bias and the output; input gradient: the
gradient, the weight and the input gradient; weight gradient: the
gradient, the input and the weight gradient).
"""

from __future__ import annotations


def convs(model: dict):
    """(C_in, C_out, K) of each convolution."""
    widths = [model["in_features"]] + [c // 2 for c in model["channels"]]
    yield from zip(widths, model["channels"], model["kernels"])


def conv_work(model: dict, batch: int, t_pad: int, train: bool = True) -> tuple:
    """(operations, bytes) of the convolutions at (batch, t_pad) frames:
    forward, and with ``train`` the weight and input gradients."""
    ops = nbytes = 0.0
    rows = batch * t_pad
    for i, (cin, cout, k) in enumerate(convs(model)):
        fwd = 2.0 * rows * cout * cin * k
        w = cout * cin * k
        ops += fwd
        nbytes += 4.0 * (rows * cin + w + cout + rows * cout)
        if train:
            ops += fwd  # weight gradient
            nbytes += 4.0 * (rows * cout + rows * cin + w)
            if i:
                ops += fwd  # input gradient
                nbytes += 4.0 * (rows * cout + w + rows * cin)
    return ops, nbytes


def encoder_flops(model: dict, batch: int, t_pad: int, train: bool = True) -> float:
    """Operations of the encoder: the convolutions and the two linear
    layers, forward and with ``train`` their gradients."""
    rows = batch * t_pad
    half = model["hidden"] // 2
    linear = 2.0 * rows * (model["hidden"] * (model["channels"][-1] // 2)
                           + model["num_labels"] * half)
    return conv_work(model, batch, t_pad, train)[0] + linear * (3 if train else 1)
