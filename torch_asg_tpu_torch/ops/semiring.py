"""Log-semiring primitives for the ASG lattices (PyTorch).

The criterion runs in the log semiring (oplus = logsumexp, otimes = +,
zero = -inf, one = 0); the Viterbi decoder in the tropical semiring
(oplus = max).  Every primitive here is -inf-safe: a row that is entirely
-inf reduces to -inf, never NaN.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def logsumexp(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """-inf-safe logsumexp along ``dim``: all--inf rows give -inf."""
    m = torch.amax(x, dim=dim, keepdim=True)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    s = torch.sum(torch.exp(x - m_safe), dim=dim, keepdim=True)
    out = torch.where(
        finite, torch.log(torch.where(s > 0, s, torch.ones_like(s))) + m_safe, m
    )
    return out if keepdim else out.squeeze(dim)


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise 2-way log-semiring sum; -inf + -inf gives -inf."""
    m = torch.maximum(a, b)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    return torch.where(
        finite, torch.log(torch.where(s > 0, s, torch.ones_like(s))) + m_safe, m
    )
