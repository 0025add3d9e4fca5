"""torch_asg_tpu_torch: the Auto Segmentation Criterion (ASG) in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100.

The port of ``torch_asg_tpu`` (JAX + Pallas), which stays the reference.
It carries the serving path (the Wav2Letter encoder, ASG scores and 1-best
Viterbi decoding), the training path (ASG loss gradients, ``ASGLoss`` and
the Wav2Letter train step in ``models``), wordpiece-vocabulary training
through the matmul tier (``impl='matmul'``, which ``'auto'`` picks past 512
labels), the per-lattice tier (``impl='pallas'``: one set of kernels for the
full lattice and one for the aligned lattice), forced alignment
(``viterbi_align``, ``alignment_segments``), the lattice posteriors
(``fcc_posteriors``, ``fac_posteriors``) with the minimum-frame-risk decode
``posterior_decode``, the n-best and beam decoders (``viterbi_nbest``,
``beam_decode``, ``beam_nbest``; plain PyTorch, as the JAX package has no
kernel for them), and the host runtime in ``runtime`` (a native data path,
bucketing, and a prefetcher that copies batches to the card on a side
stream).  Entry points run where their tensors lie: CUDA tensors launch the
kernels, CPU tensors run each kernel's plain PyTorch version.
"""

from .asg import ASGLoss, asg_loss, asg_scores
from .ops.fac import fac_score
from .ops.fcc import fcc_score
from .ops.posteriors import fac_posteriors, fcc_posteriors, posterior_decode
from .ops.viterbi import (AlignmentResult, NBestResult, ViterbiResult,
                         alignment_segments, beam_decode, beam_nbest, viterbi_align,
                         viterbi_decode, viterbi_nbest)

__version__ = "0.1.0"

__all__ = [
    "ASGLoss",
    "asg_loss",
    "asg_scores",
    "fcc_score",
    "fac_score",
    "fcc_posteriors",
    "fac_posteriors",
    "posterior_decode",
    "viterbi_decode",
    "viterbi_nbest",
    "beam_decode",
    "beam_nbest",
    "viterbi_align",
    "alignment_segments",
    "ViterbiResult",
    "AlignmentResult",
    "NBestResult",
]
