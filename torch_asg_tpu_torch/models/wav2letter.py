"""Wav2Letter-style convolutional acoustic model.

A 1-D convolutional encoder over acoustic features that emits per-frame
label scores shaped (T', B, N), which is what the ASG criterion and the
Viterbi decoder consume.  The public layout is the JAX package's:
features (B, T, F) in, emissions (T', B, N) out.  Inside, every block takes
and gives channels-last activations (B, T, C), and ``conv_route`` picks
how it convolves them: on the card, a float32 block of stride 1 (of any
width) runs the hand-written channels-last convolution
(``ops/kernels/conv_kernels.py``: SAME padding by predicate, bias and ReLU
fused), so the stride-1 stack makes no padded or transposed copy and the
head reads the last block's output as it lies; every other block runs
``F.conv1d`` on the channels-first view, as ``nn.Conv1d`` wants.

Dropout, when ``dropout > 0``, fires only in calls with ``train=True``, as
the Flax model's ``deterministic=not train`` does (the module's own
train/eval mode does not switch it), and draws its masks from the
``generator`` given, so a trainer controls the random stream.

Padding is the Flax "SAME" rule: output length ceil(L / stride), with
``total = max((ceil(L/s) - 1) * s + k - L, 0)`` padded ``total // 2`` on the
left and the rest on the right.  That split is asymmetric when ``total`` is
odd, which ``nn.Conv1d`` cannot express, so each ``F.conv1d`` block pads
with ``F.pad`` before a ``padding=0`` convolution.

Tensor parallelism: when ``models.train.shard_train_state`` has placed the
parameters on a ('data', 'model') ``DeviceMesh``, each convolution's weight
and bias are DTensors split along their output channels over 'model' and
the head is replicated.  Each rank then runs its own block, written with
the collectives of ``parallel/``, not DTensor's dispatch (which would
gather every weight): it convolves the replicated input with its
(Cout/M, Cin, K) block, applies the ReLU and gathers the channels, so the
next block's Cin contraction is local (the Flax model's output-channel
split).  The input's gradient is all-reduced over 'model', since each
rank's channels give a part of it.  Dropout follows the gather: the mask is
the rows of this rank's 'data' block of the mask drawn for the whole batch,
so every 'model' rank of a data group draws the same one, and the step
draws what the single-process step draws.

Under a profiler each stage of blocks (front end, mid stack, wide block) is
a span of its own, forward and backward, on either branch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops.kernels.common import DEFAULT_DEVICE
from ..ops.kernels.conv_kernels import conv_relu
from ..parallel.collectives import gather_channels, mesh_axis, replicated_input
from ..utils.profiling import span, spanned

# The mesh axes of a sharded model: the convolutions' output channels split
# over TP_AXIS (the Flax model's ``tp_axis``), the batch over DP_AXIS.
TP_AXIS = "model"
DP_AXIS = "data"


def same_padding(length: int, kernel: int, stride: int) -> tuple:
    """(left, right) padding of a Flax/XLA "SAME" convolution."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def dropout(x: torch.Tensor, rate: float, generator=None, block=(1, 0)) -> torch.Tensor:
    """Inverted dropout: zero each element with probability ``rate`` and
    scale the rest by 1 / (1 - rate); masks come from ``generator``.
    ``block`` = (D, d): ``x`` is block d of a batch split into D equal
    blocks along dim 0, and its mask is those rows of the whole batch's."""
    size, index = block
    rows = x.shape[0]
    keep = x.new_empty((size * rows, *x.shape[1:])).bernoulli_(1.0 - rate, generator=generator)
    return x * keep[index * rows:(index + 1) * rows] / (1.0 - rate)


def local_block(p: DTensor, placements: tuple) -> torch.Tensor:
    """This rank's block of a parameter placed by ``shard_train_state``;
    raises unless it has ``placements``."""
    if tuple(p.placements) != placements:
        raise ValueError(f"a parameter placed {tuple(p.placements)} on mesh axes "
                         f"{p.device_mesh.mesh_dim_names}; the tensor-parallel forward "
                         f"needs {placements}")
    return p.to_local()


def data_block(mesh) -> tuple:
    """(D, d): the 'data' axis's size and this rank's coordinate on it."""
    if DP_AXIS not in (mesh.mesh_dim_names or ()):
        return 1, 0
    ax = mesh_axis(mesh, DP_AXIS)
    return ax.size, ax.index


def conv_route(device: torch.device, dtype: torch.dtype, stride: int, kernel: int,
               sharded: bool) -> str:
    """How a block convolves: ``'sharded'`` where its weight is a DTensor (the
    tensor-parallel ``F.conv1d`` of the module docstring); ``'kernel'`` on a
    CUDA device in float32 at stride 1, of odd or even width (the SAME pads
    of an even width are one frame wider on the right:
    ``conv_kernels.same_pads``); else ``'conv1d'`` (``F.conv1d`` on the
    channels-first view: cuDNN for the strided front end on the card, and
    every block on the CPU).  ``kernel``, the block's width, does not
    change the route."""
    if sharded:
        return "sharded"
    if device.type == "cuda" and dtype == torch.float32 and stride == 1:
        return "kernel"
    return "conv1d"


class ConvBlock(nn.Module):
    """SAME-padded Conv1d + ReLU (+ dropout when training)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, features, kernel, stride=stride,
                              padding=0, device=device, dtype=dtype)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        """x: (B, T, C) -> (B, ceil(T / stride), features), channels last,
        by ``conv_route``'s path; tensor-parallel when the weight is a
        DTensor split over ``TP_AXIS`` (module docstring).  Dropout draws its
        mask in the channels-first layout on every path."""
        conv, block = self.conv, (1, 0)
        route = conv_route(x.device, conv.weight.dtype, conv.stride[0], conv.kernel_size[0],
                           isinstance(conv.weight, DTensor))
        if route == "kernel":
            x = conv_relu(x.contiguous(), conv.weight, conv.bias).transpose(1, 2)
        else:
            x = x.transpose(1, 2)  # (B, C, T)
            pads = same_padding(x.shape[-1], conv.kernel_size[0], conv.stride[0])
            if route == "sharded":
                mesh = conv.weight.device_mesh
                model = mesh_axis(mesh, TP_AXIS)
                split = tuple(Shard(0) if n == TP_AXIS else Replicate()
                              for n in mesh.mesh_dim_names)
                x = F.conv1d(F.pad(replicated_input(x, model), pads),
                             local_block(conv.weight, split), local_block(conv.bias, split),
                             conv.stride)
                x = gather_channels(F.relu(x), model)
                block = data_block(mesh)
            else:
                x = F.relu(conv(F.pad(x, pads)))
        if train and self.dropout > 0.0:
            x = dropout(x, self.dropout, generator, block)
        return x.transpose(1, 2)


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
        self.num_labels = num_labels
        self.dropout = dropout
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

    def forward(self, features: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        """features (B, T, F) -> emissions (T', B, N); ``train`` turns
        dropout on, with masks drawn from ``generator``.  Under a profiler
        the call is the span ``asg.encoder`` and each stage
        ``asg.encoder.<stage>``, forward and backward (``utils/profiling.py``)."""
        b = list(self.blocks)  # the strided front end, the mid stack, the wide block
        stages = [(n, s) for n, s in (("frontend", b[:1]), ("mid", b[1:-1]), ("wide", b[-1:]))
                  if s]
        with span("asg.encoder"):
            x = features  # (B, T, F): every block takes and gives channels last
            for name, blocks in stages:
                def run(x, blocks=blocks):
                    for block in blocks:
                        x = block(x, train, generator)
                    return x
                x = spanned(f"asg.encoder.{name}", run, x)
            weight, bias = self.proj.weight, self.proj.bias
            if isinstance(weight, DTensor):  # replicated: every rank's is the whole
                whole = (Replicate(),) * weight.device_mesh.ndim
                x = F.linear(x, local_block(weight, whole), local_block(bias, whole))
            else:
                x = self.proj(x)  # (B, T', N)
            return x.transpose(0, 1)  # (T', B, N) for the criterion

    def output_length(self, input_length):
        """Frames emitted for a given feature length (SAME padding)."""
        return -(-input_length // self.frontend_stride)
