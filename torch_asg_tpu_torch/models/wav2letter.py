"""Wav2Letter-style convolutional acoustic model.

A 1-D convolutional encoder over acoustic features that emits per-frame
label scores shaped (T', B, N), which is what the ASG criterion and the
Viterbi decoder consume.  The public layout is the JAX package's:
features (B, T, F) in, emissions (T', B, N) out; inside, the convolutions
run channels-first as ``nn.Conv1d`` wants.

Padding is the Flax "SAME" rule: output length ceil(L / stride), with
``total = max((ceil(L/s) - 1) * s + k - L, 0)`` padded ``total // 2`` on the
left and the rest on the right.  That split is asymmetric when ``total`` is
odd, which ``nn.Conv1d`` cannot express, so each block pads with ``F.pad``
before a ``padding=0`` convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.common import DEFAULT_DEVICE


def same_padding(length: int, kernel: int, stride: int) -> tuple:
    """(left, right) padding of a Flax/XLA "SAME" convolution."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """SAME-padded Conv1d + ReLU (+ dropout when training)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, features, kernel, stride=stride,
                              padding=0, device=device, dtype=dtype)
        self.dropout = nn.Dropout(dropout) if dropout > 0.0 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T) -> (B, features, ceil(T / stride))."""
        pads = same_padding(x.shape[-1], self.conv.kernel_size[0], self.conv.stride[0])
        x = F.pad(x, pads)
        return self.dropout(F.relu(self.conv(x)))


class Wav2Letter(nn.Module):
    """Conv encoder: features (B, T, F) -> emissions (T', B, N).

    num_labels: vocabulary size N (letters + ASG repeat symbols).
    channels: mid-stack width.  depth: number of stride-1 mid blocks.
    Parameters are created on ``device`` (the card unless told otherwise).
    """

    def __init__(self, num_labels: int, in_features: int, channels: int = 256,
                 depth: int = 6, head_channels: int = 512,
                 frontend_kernel: int = 11, frontend_stride: int = 2,
                 kernel: int = 7, dropout: float = 0.0,
                 device=DEFAULT_DEVICE, dtype=None):
        super().__init__()
        self.frontend_stride = frontend_stride
        kw = dict(dropout=dropout, device=device, dtype=dtype)
        blocks = [ConvBlock(in_features, channels, frontend_kernel,
                            frontend_stride, **kw)]
        blocks += [ConvBlock(channels, channels, kernel, 1, **kw)
                   for _ in range(depth)]
        blocks.append(ConvBlock(channels, head_channels, kernel, 1, **kw))
        self.blocks = nn.ModuleList(blocks)
        # final 1x1 projection to label scores
        self.proj = nn.Linear(head_channels, num_labels, device=device, dtype=dtype)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features.transpose(1, 2)  # (B, F, T)
        for block in self.blocks:
            x = block(x)
        x = self.proj(x.transpose(1, 2))  # (B, T', N)
        return x.transpose(0, 1)  # (T', B, N) for the criterion

    def output_length(self, input_length):
        """Frames emitted for a given feature length (SAME padding)."""
        return -(-input_length // self.frontend_stride)
