"""Posterior (occupation) marginals of the ASG lattices, and the
minimum-frame-risk decode built on them.

gamma = alpha + beta normalised per frame: soft alignments for
distillation, confidence estimation and lattice visualisation.  The
full-lattice posterior IS ``d fcc_score / d inputs`` and the aligned
posterior is the aligned-domain gradient of ``fac_score``; the tests pin
both identities.

``posterior_decode`` tiers (``impl``):
  * ``'pallas'``: the posteriors as the gradient of the per-lattice
    denominator score ``fcc_score_pallas`` with respect to the (tau-scaled)
    emissions, so the decode runs the training kernels K3 (alpha and beta)
    and K5 (the backward) on CUDA tensors, their plain versions on CPU
    tensors.  Takes up to ``_MM_MIN_LABELS`` labels.
  * ``'scan'``: ``fcc_posteriors``, the log-domain alpha/beta scans (the
    matmul forms past ``_MM_MIN_LABELS``).
  * ``'auto'``: ``'pallas'`` up to ``_MM_MIN_LABELS`` labels, else ``'scan'``.
The ``'pallas'`` tier shares ``asg_loss``'s exp-domain spread guard, an
eager host check (``asg._spread_guard``): ``'auto'`` reroutes to ``'scan'``
past 60 * tau nats, an explicit ``'pallas'`` raises under ``validate=True``
and reroutes under ``validate='reroute'``.  The JAX package's traced arms
(NaN-poisoned scores, an in-graph dispatch) have no counterpart: PyTorch
runs eagerly, so the transition is always concrete.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..asg import _spread_guard
from .fac import _alpha_scan as _fac_alpha, _beta_scan as _fac_beta, make_aligned
from .fcc import (_alpha_scan as _fcc_alpha, _alpha_scan_mm,
                  _beta_scan as _fcc_beta, _beta_scan_mm)
from .kernels.fcc_kernels import fcc_score_pallas
from .kernels.viterbi_kernels import argmax_first
from .semiring import masked_softmax
from .viterbi import ViterbiResult
from ..utils.lengths import default_lengths, mask_emissions, time_mask

# Above this label count the (B, N, N) step of the plain scans is the
# memory problem; the matmul forms (same math, O(B N) a step) take over, as
# asg.py's 'auto' moves to 'matmul'.
_MM_MIN_LABELS = 512


def _check_temperature(temperature: float):
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")


def _scaled(transition, inputs, temperature):
    """(transition, inputs) in one float dtype on the inputs' device,
    divided by ``temperature``."""
    if inputs.dtype in (torch.bfloat16, torch.float16):
        inputs = inputs.float()
    transition = transition.to(device=inputs.device, dtype=inputs.dtype)
    if temperature != 1.0:
        inv = 1.0 / temperature
        transition = transition * inv
        inputs = inputs * inv
    return transition, inputs


def fcc_posteriors(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    temperature: float = 1.0,
) -> torch.Tensor:
    """(T, B, N) per-frame label posteriors under the full lattice.

    Rows sum to 1 on valid frames and are exactly 0 past each utterance's
    length; equals the gradient of ``fcc_score(...).sum()`` with respect to
    ``inputs``.  ``temperature`` tau scores the lattice at (T/tau, I/tau):
    tau > 1 softens, tau < 1 sharpens, tau -> 0 approaches the one-hot
    occupancy of the Viterbi path.
    """
    _check_temperature(temperature)
    t_total, num_batches, num_labels = inputs.shape
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, inputs.device)
    input_lengths = input_lengths.to(inputs.device)
    transition, inputs = _scaled(transition, inputs, temperature)
    inputs_m = mask_emissions(inputs, input_lengths)
    if num_labels > _MM_MIN_LABELS:
        alpha = _alpha_scan_mm(transition, inputs_m)
        beta = _beta_scan_mm(transition, inputs_m, input_lengths)
    else:
        alpha = _fcc_alpha(transition, inputs_m)
        beta = _fcc_beta(transition, inputs_m, input_lengths)
    return masked_softmax(alpha + beta, dim=2)


def fac_posteriors(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    *,
    temperature: float = 1.0,
) -> torch.Tensor:
    """(T, B, S) soft alignment: P(frame t emits target slot s | targets).

    Rows sum to 1 on valid frames and are 0 past the lengths; equals the
    aligned-domain gradient of ``fac_score``.  ``temperature`` as in
    ``fcc_posteriors``: tau -> 0 approaches the one-hot occupancy of the best
    monotone alignment.
    """
    _check_temperature(temperature)
    t_total, num_batches, _ = inputs.shape
    s_total = targets.shape[1]
    dev = inputs.device
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, dev)
    if target_lengths is None:
        target_lengths = default_lengths(num_batches, s_total, dev)
    input_lengths, target_lengths = input_lengths.to(dev), target_lengths.to(dev)
    transition, inputs = _scaled(transition, inputs, temperature)
    lat = make_aligned(transition, inputs, targets.to(dev), input_lengths, target_lengths)
    alpha = _fac_alpha(lat)
    beta = _fac_beta(lat, input_lengths, target_lengths)
    return masked_softmax(alpha + beta, dim=2)


def _pallas_posteriors(transition, inputs, input_lengths):
    """d fcc_score_pallas(...).sum() / d inputs: K3 forward, K5 backward."""
    with torch.enable_grad():
        x = inputs.detach().requires_grad_(True)
        score = fcc_score_pallas(transition.detach(), x, input_lengths).sum()
        (post,) = torch.autograd.grad(score, x)
    return post


def posterior_decode(
    transition: torch.Tensor,
    inputs: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    *,
    temperature: float = 1.0,
    impl: str = "auto",
    validate=True,
) -> ViterbiResult:
    """Minimum-frame-risk (MAP-frame) decode at temperature tau.

    The per-frame argmax of the full-lattice posteriors: the decode that
    minimises the expected frame error under the model, where
    ``viterbi_decode`` minimises the sequence error.  tau = 1 is the
    classic posterior decode, tau -> 0 recovers ``viterbi_decode``'s labels,
    tau > 1 anneals toward the uniform.

    Returns a ``ViterbiResult``: ``paths`` (T, B) int32, -1 past each
    utterance's length, ties to the lowest label; ``scores`` (B,) the
    decoded labels' posterior mass summed over valid frames, the expected
    number of correct frames (not a log path score).  ``impl`` and
    ``validate`` as in the module docstring.
    """
    _check_temperature(temperature)
    if impl not in ("auto", "scan", "pallas"):
        raise ValueError(f"unknown impl {impl!r}; expected 'auto', 'scan' or 'pallas'")
    t_total, num_batches, num_labels = inputs.shape
    if input_lengths is None:
        input_lengths = default_lengths(num_batches, t_total, inputs.device)
    input_lengths = input_lengths.to(inputs.device)
    requested = impl
    if impl == "auto":
        impl = "pallas" if num_labels <= _MM_MIN_LABELS else "scan"
    if impl == "pallas":
        guard_impl = "auto" if requested == "auto" else "pallas"
        impl = _spread_guard(transition.to(inputs.device), guard_impl, temperature,
                             validate)
        if impl == "auto":
            impl = "pallas"
    if impl == "pallas":
        if num_labels > _MM_MIN_LABELS:
            raise ValueError(
                f"impl='pallas' supports num_labels <= {_MM_MIN_LABELS}; "
                f"got {num_labels}.  Use impl='scan' (matmul form).")
        post = _pallas_posteriors(*_scaled(transition, inputs, temperature),
                                  input_lengths)
    else:
        post = fcc_posteriors(transition, inputs, input_lengths, temperature=temperature)
    best, labels = argmax_first(post, dim=2)
    valid = time_mask(t_total, input_lengths)
    paths = torch.where(valid, labels, -1).to(torch.int32)
    scores = torch.where(valid, best, torch.zeros_like(best)).sum(dim=0)
    return ViterbiResult(scores=scores, paths=paths)
