"""Multi-GPU ASG on ``torch.distributed``: batch, vocabulary and sequence
parallelism over a ``DeviceMesh``, and multi-host bring-up.

One process runs per rank (one per card; NCCL on CUDA devices, gloo on the
CPU), where the JAX package runs one process over a mesh of devices and
``jax.shard_map``.  So each ``*_dp``, ``*_vp`` and ``*_seq`` function is
the body one rank runs of the JAX ``shard_map``, and every rank of the mesh
axis must call it with the same arguments apart from its blocks:

* **Inputs:** the rank passes its block of every argument that the JAX
  ``in_specs`` split along ``axis``, and the whole of every argument that
  they replicate.
* **Outputs:** it gets back its block of every output that the JAX
  ``out_specs`` split, and the whole of every replicated output, which is
  the same on every rank.
* **Gradients:** after ``backward()`` on every rank, the gradient of a
  split argument is the rank's block of the single-process gradient, and
  the gradient of a replicated argument (the transition of ``asg_loss_dp``
  and ``asg_loss_seq``) is the whole single-process gradient, on every
  rank.  Work that every rank computes alike counts once, not P times.

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` (``make_mesh``,
``make_hybrid_mesh``) and ``axis`` names one of its dimensions, with the
JAX defaults ('data', 'model', 'seq').  Reductions 'mean' and 'sum' run
over the global batch.  A split dimension whose blocks differ in size
raises the JAX package's "not divisible" error.
"""

from .data_parallel import (
    asg_loss_dp,
    beam_decode_dp,
    shard_batch,
    viterbi_align_dp,
    viterbi_decode_dp,
)
from .distributed import init_distributed, local_batch_slice, make_hybrid_mesh
from .mesh import make_mesh
from .sequence_parallel import asg_loss_seq
from .vocab_parallel import asg_loss_vp, fcc_score_vp

__all__ = [
    "make_mesh",
    "make_hybrid_mesh",
    "init_distributed",
    "local_batch_slice",
    "asg_loss_dp",
    "shard_batch",
    "viterbi_decode_dp",
    "viterbi_align_dp",
    "beam_decode_dp",
    "asg_loss_vp",
    "fcc_score_vp",
    "asg_loss_seq",
]
