"""Length-masking helpers.

Ragged batches stay static-shaped: emissions outside ``t < input_lengths[b]``
are forced to the semiring zero (-inf), and the beta recursions re-seed at
``t == input_lengths[b] - 1``.
"""

from __future__ import annotations

import torch

from ..ops.semiring import NEG_INF


def time_mask(batch_input_len: int, input_lengths: torch.Tensor) -> torch.Tensor:
    """(T, B) bool mask: True where frame t is valid for batch b."""
    t = torch.arange(batch_input_len, device=input_lengths.device)
    return t[:, None] < input_lengths[None, :]


def label_mask(batch_output_len: int, target_lengths: torch.Tensor) -> torch.Tensor:
    """(B, S) bool mask: True where target slot s is valid for batch b."""
    s = torch.arange(batch_output_len, device=target_lengths.device)
    return s[None, :] < target_lengths[:, None]


def mask_emissions(inputs: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """Force emissions (T, B, N) at invalid frames to -inf."""
    mask = time_mask(inputs.shape[0], input_lengths)
    return inputs.masked_fill(~mask[:, :, None], NEG_INF)


def default_lengths(n: int, length: int, device) -> torch.Tensor:
    """Full-length int32 vector used when the caller passes lengths=None."""
    return torch.full((n,), length, dtype=torch.int32, device=device)
