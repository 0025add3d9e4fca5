"""torch_asg_tpu_torch: the Auto Segmentation Criterion (ASG) in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100.

The port of ``torch_asg_tpu`` (JAX + Pallas), which stays the reference.
This slice carries the serving path: the Wav2Letter encoder, forward-only
ASG scores and 1-best Viterbi decoding.  Entry points run where their
tensors lie: CUDA tensors launch the kernels, CPU tensors run each kernel's
plain PyTorch version.
"""

from .asg import asg_loss, asg_scores
from .ops.fac import fac_score
from .ops.fcc import fcc_score
from .ops.viterbi import ViterbiResult, viterbi_decode

__version__ = "0.1.0"

__all__ = [
    "asg_loss",
    "asg_scores",
    "fcc_score",
    "fac_score",
    "viterbi_decode",
    "ViterbiResult",
]
