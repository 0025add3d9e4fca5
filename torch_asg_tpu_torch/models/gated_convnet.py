"""Gated convolutional acoustic model: wav2letter's letter ConvNet with gated
linear units (Liptchinsky, Synnaeve and Collobert 2017, "Letter-Based
Speech Recognition with Gated ConvNets", arXiv:1712.09444; the LibriSpeech
model of wav2letter's ``conv_glu`` recipe).

For i = 1 .. L (L = 17 in the published model), on features (B, T, F):

* ``z_i = conv1d_SAME(h_{i-1}; w_i, b_i)``, stride 1, width ``K_i``;
* ``w_i = g_i * v_i / ||v_i||``: weight normalisation, one norm an output
  channel over (C_in, K_i);
* ``h_i = dropout_{p_i}(GLU(z_i))``, ``GLU(z) = z[:, :C/2] * sigmoid(z[:, C/2:])``
  over the channels, so layer i + 1 reads ``C_out,i / 2`` channels;

then ``h_{L+1} = dropout_{p_{L+1}}(GLU(WN-linear(h_L)))`` and the emissions
``WN-linear(h_{L+1})``, one a frame (no stride).  The published widths are
the defaults: ``C_out,i`` = 400, 440, ..., 1816 (about 1.1x a layer),
``K_i = 12 + i``, ``p_i = 0.2 * 1.07 ** (i - 1)`` and 40 log-mel features
in; the hidden linear layer is 908 -> 1816 and the emissions 908 -> N;
208.86 M parameters at N = 30.

The public layout is ``Wav2Letter``'s: features (B, T, F) in, emissions
(T, B, N) out, channels last inside.  Each convolution goes through
``wav2letter.conv_route``: on the card in float32, the hand-written
channels-last convolution with the bias fused and no ReLU
(``conv_kernels.conv_bias``) at every width, odd or even; elsewhere
``F.conv1d`` on the channels-first view after an ``F.pad`` of the SAME
pads.  The GLU is ``F.glu`` on the channels-last output.  The weights are
made from their (v, g) pairs once a forward, every layer's at its start,
in plain torch ops that autograd differentiates.  Dropout, with
``train=True``, is ``wav2letter.dropout`` on the channels-first view,
drawing one mask a layer in layer order from ``generator``.

The module has the interface ``make_train_step``, ``loss_fn`` and
``create_train_state`` use: ``forward(features, train, generator)``,
``output_length``, ``num_labels`` and ``dropout`` (the largest rate; a
train step turns dropout on where it is above 0).

Under a profiler the forward is the span ``asg.encoder``; inside it
``asg.weight_norm`` (all the weights), ``asg.encoder.gated`` (the
convolutions) and ``asg.encoder.head`` (the two linear layers), each with
its ``.backward`` (``utils/profiling.py``).  The weights' backward runs
after every layer's, since they are made first.

Not provided: a tensor-parallel forward (a DTensor weight, as
``shard_train_state`` places it, raises), serving and the decoders' use of
this model.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..ops.kernels.common import DEFAULT_DEVICE
from ..ops.kernels.conv_kernels import conv_bias
from ..utils.profiling import span, spanned
from .wav2letter import conv_route, dropout, same_padding

# The LibriSpeech model of arXiv:1712.09444 (wav2letter's conv_glu recipe)
CHANNELS = (400, 440, 484, 532, 584, 642, 706, 776, 852, 936, 1028, 1130, 1242, 1366, 1502,
            1652, 1816)
KERNELS = tuple(range(13, 30))
DROPOUTS = tuple(0.2 * 1.07 ** i for i in range(17)) + (0.2 * 1.07 ** 16,)
HIDDEN = 1816
IN_FEATURES = 40
# v's variance times its fan-in at initialisation: at the published rates it
# keeps the emissions' scale near 1 with dropout on (each layer's inverted
# dropout multiplies its variance by 1 / (1 - p)); above it the training
# stack turns chaotic
WEIGHT_SCALE = 2.1


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||``, one norm over every dimension but the first."""
    dims = tuple(range(1, v.dim()))
    scale = g / torch.linalg.vector_norm(v, dim=dims)
    return v * scale.view(-1, *(1,) * len(dims))


class _WeightNormed(nn.Module):
    """A weight held as (v, g), ``g`` (out,) starting at ``||v||`` a row as
    wav2letter initialises it, and a bias starting at zero.  ``v`` is
    normal with variance ``WEIGHT_SCALE`` / fan-in."""

    def __init__(self, shape: tuple, device, dtype):
        super().__init__()
        fan_in = math.prod(shape[1:])
        v = torch.randn(shape, device=device, dtype=dtype) * math.sqrt(WEIGHT_SCALE / fan_in)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(torch.linalg.vector_norm(v, dim=tuple(range(1, len(shape)))))
        self.bias = nn.Parameter(torch.zeros(shape[0], device=device, dtype=dtype))

    def weight(self) -> torch.Tensor:
        return weight_norm(self.weight_v, self.weight_g)


class GatedConvNet(nn.Module):
    """Gated ConvNet encoder: features (B, T, F) -> emissions (T, B, N).

    channels: each convolution's output width (the GLU halves it).
    kernels: each convolution's width.  dropout: a rate for each
    convolution, then the hidden linear layer's.  hidden: the hidden
    linear layer's output width.  Parameters are created on ``device`` (the
    card unless told otherwise).
    """

    def __init__(self, num_labels: int, in_features: int = IN_FEATURES,
                 channels: Sequence[int] = CHANNELS, kernels: Sequence[int] = KERNELS,
                 dropout: Sequence[float] = DROPOUTS, hidden: int = HIDDEN,
                 device=DEFAULT_DEVICE, dtype=None):
        super().__init__()
        if not len(channels) == len(kernels) == len(dropout) - 1:
            raise ValueError(f"{len(channels)} widths, {len(kernels)} kernels and "
                             f"{len(dropout)} rates: give a rate for each convolution "
                             f"and one for the hidden linear layer")
        if any(c % 2 for c in (*channels, hidden)):
            raise ValueError(f"the GLU halves every width: {tuple(channels)}, {hidden} "
                             f"must be even")
        self.num_labels = num_labels
        self.dropouts = tuple(float(p) for p in dropout)
        self.dropout = max(self.dropouts, default=0.0)
        kw = dict(device=device, dtype=dtype)
        widths = [in_features] + [c // 2 for c in channels]
        self.convs = nn.ModuleList(_WeightNormed((cout, cin, k), **kw)
                                   for cin, cout, k in zip(widths, channels, kernels))
        self.hidden = _WeightNormed((hidden, widths[-1]), **kw)
        self.out = _WeightNormed((num_labels, hidden // 2), **kw)

    def _check_plain(self) -> None:
        if any(isinstance(p, DTensor) for p in self.parameters()):
            raise ValueError("GatedConvNet has no tensor-parallel forward: its weights must "
                             "be plain tensors, not DTensors placed by shard_train_state")

    def _drop(self, x: torch.Tensor, i: int, train: bool, generator) -> torch.Tensor:
        """Layer ``i``'s dropout, its mask drawn on the channels-first view."""
        if not (train and self.dropouts[i] > 0.0):
            return x
        return dropout(x.transpose(1, 2), self.dropouts[i], generator).transpose(1, 2)

    def _conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``conv1d_SAME(x) + b`` on channels-last ``x`` (B, T, C), by
        ``conv_route``."""
        k = w.shape[-1]
        if conv_route(x.device, w.dtype, 1, k, False) == "kernel":
            return conv_bias(x.contiguous(), w, b)
        pads = same_padding(x.shape[1], k, 1)
        return F.conv1d(F.pad(x.transpose(1, 2), pads), w, b).transpose(1, 2)

    def forward(self, features: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """features (B, T, F) -> emissions (T, B, N); ``train`` turns dropout
        on, with masks drawn from ``generator``."""
        self._check_plain()
        layers = [*self.convs, self.hidden, self.out]
        with span("asg.encoder"):
            weights = spanned("asg.weight_norm",
                              lambda: tuple(layer.weight() for layer in layers))

            def gated(x):
                for i, (layer, w) in enumerate(zip(self.convs, weights)):
                    x = F.glu(self._conv(x, w, layer.bias), dim=-1)
                    x = self._drop(x, i, train, generator)
                return x

            def head(x):
                x = F.glu(F.linear(x, weights[-2], self.hidden.bias), dim=-1)
                x = self._drop(x, len(self.convs), train, generator)
                return F.linear(x, weights[-1], self.out.bias)

            x = spanned("asg.encoder.gated", gated, features)
            return spanned("asg.encoder.head", head, x).transpose(0, 1)

    def output_length(self, input_length):
        """Frames emitted for a given feature length: one a frame."""
        return input_length
