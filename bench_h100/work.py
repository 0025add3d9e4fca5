"""Operations and bytes of the layers, counted from shapes, and the H100's
peaks.

The least time of a piece of work is the larger of its float32 operations
over the card's float32 rate (outside the tensor cores: TF32 is off) and
its bytes over the memory rate: ``bound_s`` (the same arithmetic as
``chip_smoke.bound``).  Peaks are NVIDIA's data sheet for the H100 SXM at
its full 700 W; a card set lower reads lower.

**Criterion** (``criterion_work``): ASG forward and backward of one batch,
counted the same whichever tier runs it, as the exp-domain
forward-backward algorithm needs it.  For an utterance of L emission
frames, N labels and S target labels, each of its L - 1 frame transitions
costs
  * fully-connected lattice: the alpha and the beta product, N^2
    multiply-adds each, the transition gradient's outer product, N^2 more,
    and the emission posteriors, a multiply and an add a label:
    6 N^2 + 2 N operations;
  * aligned lattice: alpha and beta, two products and a sum a slot each,
    and the two edge posteriors (four operations a slot): 12 S operations.
Frames past L and slots past S are not counted.  Bytes: the emissions read
once and their gradient written once at the padded (T', B, N), the targets
and both length vectors read, the transition read and its gradient written.

**Encoder** (``encoder_flops``): each convolution's 2 B T_out C_out C_in K
operations forward, as many for the weight gradient, and as many for the
input gradient except the first layer's (its input needs none); the head
projection likewise.  Counted over the padded shapes the step computes;
biases and ReLUs are left out, and nothing recomputed is counted.
"""

from __future__ import annotations

import numpy as np

FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds of work of ``ops`` float32 operations and ``nbytes``
    bytes moved."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def criterion_work(num_labels: int, emission_lengths, target_lengths, t_pad: int,
                   s_pad: int) -> tuple:
    """(operations, bytes) of ASG forward and backward of one batch."""
    el = np.asarray(emission_lengths, np.int64)
    tl = np.asarray(target_lengths, np.int64)
    steps = np.maximum(el - 1, 0)
    n = num_labels
    ops = float((steps * (6 * n * n + 2 * n + 12 * tl)).sum())
    b = len(el)
    nbytes = 4.0 * (2 * t_pad * b * n + b * s_pad + 2 * b + 2 * n * n)
    return ops, nbytes


def _layers(model: dict):
    """(C_in, C_out, K, stride) of each convolution."""
    yield (model["in_features"], model["channels"], model["frontend_kernel"],
           model["frontend_stride"])
    for _ in range(model["depth"]):
        yield model["channels"], model["channels"], model["kernel"], 1
    yield model["channels"], model["head_channels"], model["kernel"], 1


def encoder_flops(model: dict, batch: int, t_pad: int, train: bool = True) -> float:
    """Operations of the encoder at (batch, t_pad) feature frames: forward,
    and with ``train`` the weight and input gradients."""
    total, length = 0.0, t_pad
    for i, (cin, cout, k, stride) in enumerate(_layers(model)):
        length = -(-length // stride)
        fwd = 2.0 * batch * length * cout * cin * k
        total += fwd * ((3 if i else 2) if train else 1)
    head = 2.0 * batch * length * model["head_channels"] * model["num_labels"]
    return total + head * (3 if train else 1)
