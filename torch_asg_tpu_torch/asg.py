"""ASG criterion front-end: ``asg_scores``, ``asg_loss`` and ``ASGLoss``.

Loss per batch element:  L_b = S_full(b) - S_aligned(b)  (>= 0), where
S_full is the fully-connected (denominator) log-partition score and
S_aligned the force-aligned (numerator) score.

Tiers (``impl``):
  * ``'fused'``: both beta chains in one pass and, under autograd, both
    alpha chains and every gradient in a second
    (``ops/kernels/asg_kernels.py``): the hand-written kernels on CUDA
    tensors, their plain versions on CPU tensors.  Exp-domain FCC chains.
    Takes up to ``_FUSED_MAX_WIDTH`` labels and target slots.
  * ``'matmul'``: for wordpiece vocabularies.  The FCC chains run as one
    (B, N) x (N, N) product with ``exp(T - c)`` a step
    (``ops/fcc.py::fcc_score_matmul``); under autograd on CUDA tensors the
    dual-stream kernel K9 runs both chains with one pass over the matrix
    per paired step, and the transition gradient is one (N, TB) x (TB, N)
    product.  The FAC side is the scan tier's ``fac_score``.
  * ``'pallas'``: the per-lattice tier, one set of kernels a lattice
    (``ops/kernels/fcc_kernels.py``, ``ops/kernels/fac_kernels.py``):
    log-domain FCC chains, alpha and beta together (K3) or beta alone for
    a score-only call (K4), and their backward (K5); the FAC alpha (K6),
    beta (K7) and backward (K8), then ``scatter_to_full``.  Kernels on
    CUDA tensors, their plain versions on CPU tensors.  Takes up to
    ``_FUSED_MAX_WIDTH`` labels and target slots.
  * ``'auto'``: ``'fused'``, or ``'matmul'`` past ``_FUSED_MAX_WIDTH``.
  * ``'scan'``: the log-domain scan oracle (``ops/fcc.py``, ``ops/fac.py``),
    exact for any finite transition magnitudes.

Every tier is differentiable in ``transition`` and ``inputs``; a call that
autograd will not differentiate computes the scores alone.  ``precision=``
sets the chain precision (``ops/semiring.py``) for the call.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from .ops.fac import fac_score
from .ops.fcc import fcc_score, fcc_score_matmul
from .ops.kernels.asg_kernels import asg_scores_fused
from .ops.kernels.common import DEFAULT_DEVICE
from .ops.kernels.fac_kernels import fac_score_pallas
from .ops.kernels.fcc_kernels import fcc_score_pallas
from .ops.semiring import strict_chain_precision
from .utils.lengths import default_lengths

REDUCTIONS = ("mean", "sum", "none")
IMPLS = ("scan", "pallas", "fused", "matmul", "auto")

# Exp-domain safety bound (nats) on the finite transition spread
# max(finite T) - min(finite T).  The fused, matmul and per-lattice tiers
# contract against exp(T - max T); past the fp32 exp range scores silently
# go -inf (and the per-lattice backward's exp(-log s) overflows).  -inf
# entries are exempt: they are the semiring zero and fully supported.
_EXP_SPREAD_LIMIT = 60.0

# Widest label / target width the fused tier takes (the JAX package's VMEM
# budget, kept so both packages accept the same shapes).
_FUSED_MAX_WIDTH = 512


def _prep(inputs, targets, input_lengths, target_lengths, t_total=None):
    """The criterion's front-end normalisation.  ``t_total`` is the global
    frame count when ``inputs`` holds a block of the frames (default: all
    of them)."""
    num_batches = inputs.shape[1]
    t_total = inputs.shape[0] if t_total is None else t_total
    s_total = targets.shape[1]
    dev = inputs.device
    # half-precision emissions are upcast at the criterion boundary: the
    # lattice recursions accumulate over T steps
    if inputs.dtype in (torch.bfloat16, torch.float16):
        inputs = inputs.float()
    if target_lengths is None:
        target_lengths = default_lengths(num_batches, s_total, dev)
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, dev)
    targets = targets.to(dev)
    input_lengths = input_lengths.to(dev)
    target_lengths = target_lengths.to(dev)
    # targets longer than the input can never be aligned: clamp the padded S
    if s_total > t_total:
        targets = targets[:, :t_total]
        target_lengths = torch.clamp(target_lengths, max=t_total)
    return inputs, targets, input_lengths, target_lengths


def _reduce(result: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "sum":
        return result.sum()
    if reduction == "mean":
        return result.mean()
    if reduction == "none":
        return result
    raise ValueError(f"unknown reduction {reduction!r}; expected one of {REDUCTIONS}")


def _spread_guard(transition: torch.Tensor, impl: str, temperature: float, validate) -> str:
    """Check the exp-domain precondition on the host; returns the impl to run.

    'auto' with a finite spread past the bound routes to the log-domain
    'scan' tier; an explicit exp-domain tier raises under ``validate=True``
    and reroutes under ``validate='reroute'``; a falsy ``validate`` skips the
    check.  Cost: one (N, N) reduction and one host sync per call.
    """
    if not validate:
        return impl
    if validate not in (True, "reroute"):
        raise ValueError(
            f"validate must be True, False, or 'reroute'; got {validate!r}"
        )
    if impl == "scan":
        return impl
    # temperature divides the transition before the chains run
    limit = _EXP_SPREAD_LIMIT * temperature
    finite = torch.isfinite(transition)
    hi = torch.where(finite, transition, float("-inf")).amax()
    lo = torch.where(finite, transition, float("inf")).amin()
    hi, lo = torch.stack([hi, lo]).tolist()
    spread = hi - lo if lo <= hi else 0.0
    if spread > limit:
        if impl == "auto" or validate == "reroute":
            return "scan"
        raise ValueError(
            f"impl={impl!r} runs exp-domain chains whose finite "
            f"transition spread must stay within {limit:.0f} nats "
            f"(fp32 exp range); got spread={spread:.1f}.  Use -inf for "
            f"forbidden transitions (fully supported), impl='scan' "
            f"(log-domain, any finite magnitude), validate='reroute' "
            f"(silent fallback to the log-domain tier), or "
            f"validate=False to override."
        )
    return impl


def _scores_scan(transition, inputs, targets, li, lo):
    return (
        fcc_score(transition, inputs, li),
        fac_score(transition, inputs, targets, li, lo),
    )


def _scores_matmul(transition, inputs, targets, li, lo):
    return (
        fcc_score_matmul(transition, inputs, li),
        fac_score(transition, inputs, targets, li, lo),
    )


def _scores_pallas(transition, inputs, targets, li, lo):
    return (
        fcc_score_pallas(transition, inputs, li),
        fac_score_pallas(transition, inputs, targets, li, lo),
    )


def _resolve_impl(impl: str, num_labels: int = 0, s_total: int = 0):
    """Returns scores_fn(transition, inputs, targets, li, lo) -> (full, aligned)."""
    if max(num_labels, s_total) > _FUSED_MAX_WIDTH:
        if impl == "auto":
            impl = "matmul"
        elif impl in ("fused", "pallas"):
            raise ValueError(
                f"impl={impl!r} supports max(num_labels, s_total) <= "
                f"{_FUSED_MAX_WIDTH}; got num_labels={num_labels}, "
                f"s_total={s_total}.  Use impl='matmul' (one (N, N) product a "
                f"step) for large vocabularies."
            )
    if impl == "matmul":
        return _scores_matmul
    if impl == "pallas":
        return _scores_pallas
    if impl == "scan":
        return _scores_scan
    if impl in ("fused", "auto"):
        return asg_scores_fused
    raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def _scores(transition, inputs, targets, input_lengths, target_lengths,
            impl, temperature, validate, precision):
    inputs, targets, input_lengths, target_lengths = _prep(
        inputs, targets, input_lengths, target_lengths
    )
    dt = torch.promote_types(inputs.dtype, transition.dtype)
    inputs = inputs.to(dt)
    transition = transition.to(device=inputs.device, dtype=dt)
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    impl = _spread_guard(transition, impl, temperature, validate)
    scores_fn = _resolve_impl(impl, inputs.shape[2], targets.shape[1])
    if temperature != 1.0:
        inv = 1.0 / temperature
        transition = transition * inv
        inputs = inputs * inv
    if precision is None:
        return scores_fn(transition, inputs, targets, input_lengths, target_lengths)
    with strict_chain_precision(precision):
        return scores_fn(transition, inputs, targets, input_lengths, target_lengths)


def asg_loss(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    *,
    reduction: str = "mean",
    impl: str = "auto",
    temperature: float = 1.0,
    precision: Optional[str] = None,
    validate=True,
) -> torch.Tensor:
    """ASG loss; differentiable in ``transition`` and ``inputs``.

    Args:
      transition: (N, N); ``transition[i, j]`` scores a move from label j to i.
      inputs: (T, B, N) emission scores.  targets: (B, S) int labels.
      input_lengths / target_lengths: (B,) ints; default = full length.
      reduction: 'mean' | 'sum' | 'none'.
      impl: 'auto' | 'fused' | 'pallas' | 'matmul' | 'scan' (see the module
        docstring).
      temperature: generalized-semiring temperature tau:
        loss_tau = tau * loss(T / tau, I / tau).
      precision: None (the ambient ``semiring.chain_precision()``),
        'default' or 'highest': the chain precision for this call, held for
        its backward too.  Every float32 chain product runs in full float32
        on the H100 either way; under 'highest' the matmul tier runs its two
        scans instead of the dual-stream kernel.
      validate: True | 'reroute' | False; the host-side spread check of
        ``_spread_guard``.
    """
    full, aligned = _scores(transition, inputs, targets, input_lengths,
                            target_lengths, impl, temperature, validate, precision)
    out = full - aligned
    if temperature != 1.0:
        out = out * temperature
    return _reduce(out, reduction)


def asg_scores(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    *,
    impl: str = "auto",
    temperature: float = 1.0,
    precision: Optional[str] = None,
    validate=True,
):
    """(full_scores, aligned_scores) per batch element, shape (B,) each;
    arguments as in ``asg_loss``."""
    full, aligned = _scores(transition, inputs, targets, input_lengths,
                            target_lengths, impl, temperature, validate, precision)
    if temperature != 1.0:
        full = full * temperature
        aligned = aligned * temperature
    return full, aligned


class ASGLoss(nn.Module):
    """Module front-end holding the learned transition matrix, an
    ``nn.Parameter`` initialised to zeros.

    The constructor takes the reference's positional arguments
    ``ASGLoss(num_labels, reduction='mean', forward_only=False,
    gpu_no_stream_impl=False)``; ``gpu_no_stream_impl=True`` runs the
    log-domain ``impl='scan'`` tier.  ``impl``, ``temperature``,
    ``validate``, ``device`` and ``dtype`` are keyword-only; ``impl=None``
    means ``'auto'`` (or ``'scan'`` under ``gpu_no_stream_impl``).

    ``loss = ASGLoss(num_labels)``; ``loss(inputs, targets, ...)`` computes
    the loss with the module's settings (see ``asg_loss``).  In eval mode
    (``.eval()``) or with ``forward_only=True`` the call scores under
    ``torch.no_grad()``: it runs the score-only path, keeps no residuals,
    and ``.backward()`` on the result raises, as in the reference.
    """

    def __init__(self, num_labels: int, reduction: str = "mean",
                 forward_only: bool = False, gpu_no_stream_impl: bool = False, *,
                 impl: Optional[str] = None, temperature: float = 1.0, validate=True,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        if reduction not in REDUCTIONS:
            raise ValueError(f"unknown reduction {reduction!r}")
        self.num_labels = num_labels
        self.reduction = reduction
        self.forward_only = forward_only
        self.impl = impl or ("scan" if gpu_no_stream_impl else "auto")
        self.temperature = temperature
        self.validate = validate
        self.transition = nn.Parameter(
            torch.zeros((num_labels, num_labels), device=device, dtype=dtype))

    def forward(self, inputs, targets, input_lengths=None, target_lengths=None):
        scores_only = self.forward_only or not self.training
        with torch.no_grad() if scores_only else contextlib.nullcontext():
            return asg_loss(self.transition, inputs, targets, input_lengths,
                            target_lengths, reduction=self.reduction, impl=self.impl,
                            temperature=self.temperature, validate=self.validate)
