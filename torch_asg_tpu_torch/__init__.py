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
kernel for them), online recognition (``streaming_*``: exact prefix scores,
best path, beam, n-best, forced alignment and acceptor scores updated chunk
by chunk, plain PyTorch), generic weighted-acceptor scoring (``WFSA``,
``full_wfsa``, ``chain_wfsa``, ``lexicon_wfsa``, ``wfsa_score``,
``wfsa_viterbi``, ``wfsa_posteriors``, deterministic on every device), the
reference-signature shims ``compat`` and ``torch_compat``, and the host runtime in ``runtime`` (a native data path,
bucketing, and a prefetcher that copies batches to the card on a side
stream).  ``parallel`` runs the criterion and the decoders over several
cards on ``torch.distributed`` (batch, vocabulary and sequence parallel,
one process a rank), ``models.shard_train_state`` places a train state on
a ``DeviceMesh``, and ``utils.profiling`` traces and times.  Entry points
run where their tensors lie: CUDA tensors launch the kernels, CPU tensors
run each kernel's plain PyTorch version.
"""

from .asg import ASGLoss, asg_loss, asg_scores
from .ops.fac import fac_score
from .ops.fcc import fcc_score
from .ops.posteriors import fac_posteriors, fcc_posteriors, posterior_decode
from .ops.viterbi import (AlignmentResult, NBestResult, ViterbiResult,
                         alignment_segments, beam_decode, beam_nbest, viterbi_align,
                         viterbi_decode, viterbi_nbest)
from .ops.streaming import (StreamingAlignState, StreamingBeamState, StreamingNBestState,
                            StreamingState, StreamingViterbiState, StreamingWFSAState,
                            StreamingWFSAViterbiState, StreamTargets,
                            streaming_align_backtrace, streaming_align_init,
                            streaming_align_update, streaming_beam_backtrace,
                            streaming_beam_init, streaming_beam_nbest_backtrace,
                            streaming_beam_update, streaming_init,
                            streaming_nbest_backtrace, streaming_nbest_init,
                            streaming_nbest_update, streaming_scores, streaming_targets,
                            streaming_update, streaming_viterbi_backtrace,
                            streaming_viterbi_init, streaming_viterbi_update,
                            streaming_wfsa_init, streaming_wfsa_scores,
                            streaming_wfsa_update, streaming_wfsa_viterbi_backtrace,
                            streaming_wfsa_viterbi_init, streaming_wfsa_viterbi_update)
from .ops.wfsa import (WFSA, WFSAPath, chain_wfsa, full_wfsa, lexicon_wfsa,
                       wfsa_posteriors, wfsa_score, wfsa_viterbi)

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
    "WFSA",
    "chain_wfsa",
    "full_wfsa",
    "lexicon_wfsa",
    "wfsa_score",
    "wfsa_viterbi",
    "wfsa_posteriors",
    "StreamingState",
    "streaming_init",
    "streaming_update",
    "streaming_scores",
    "StreamTargets",
    "streaming_targets",
    "StreamingViterbiState",
    "streaming_viterbi_init",
    "streaming_viterbi_update",
    "streaming_viterbi_backtrace",
    "streaming_beam_init",
    "streaming_beam_update",
    "streaming_beam_backtrace",
    "streaming_beam_nbest_backtrace",
    "StreamingWFSAViterbiState",
    "streaming_wfsa_viterbi_init",
    "streaming_wfsa_viterbi_update",
    "streaming_wfsa_viterbi_backtrace",
    "StreamingWFSAState",
    "streaming_wfsa_init",
    "streaming_wfsa_update",
    "streaming_wfsa_scores",
    "StreamingNBestState",
    "streaming_nbest_init",
    "streaming_nbest_update",
    "streaming_nbest_backtrace",
    "StreamingAlignState",
    "StreamingBeamState",
    "streaming_align_init",
    "streaming_align_update",
    "streaming_align_backtrace",
    "ViterbiResult",
    "AlignmentResult",
    "NBestResult",
    "WFSAPath",
]
