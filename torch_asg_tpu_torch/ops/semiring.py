"""Log-semiring primitives for the ASG lattices (PyTorch).

The criterion runs in the log semiring (oplus = logsumexp, otimes = +,
zero = -inf, one = 0); the Viterbi decoder in the tropical semiring
(oplus = max).  Every primitive here is -inf-safe: a row that is entirely
-inf reduces to -inf, never NaN.
"""

from __future__ import annotations

import contextlib

import torch

NEG_INF = float("-inf")

# Precision of the exp-domain chain products: 'default' or 'highest'.  On
# the H100 every float32 chain product runs in full float32 under either
# name; the one behaviour the name selects is the matmul tier's election of
# the dual-stream kernel (``ops/fcc.py::_resolve_dual``): 'highest' keeps
# the two scans, the independent formulation the kernel is checked against.
PRECISIONS = ("default", "highest")
CHAIN_PRECISION = "default"
_PRECISION_OVERRIDE = None


def chain_precision() -> str:
    return CHAIN_PRECISION if _PRECISION_OVERRIDE is None else _PRECISION_OVERRIDE


@contextlib.contextmanager
def strict_chain_precision(precision: str = "highest"):
    """Run the chain products inside the context at ``precision``."""
    global _PRECISION_OVERRIDE
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}; got {precision!r}")
    prev = _PRECISION_OVERRIDE
    _PRECISION_OVERRIDE = precision
    try:
        yield
    finally:
        _PRECISION_OVERRIDE = prev


@contextlib.contextmanager
def ieee_fp32_products():
    """Run the float32 matrix products inside the context in full float32
    on CUDA (no TF32, whatever the caller's global setting), and restore
    the setting after."""
    matmul = torch.backends.cuda.matmul
    # the setting the caller used: PyTorch refuses to read the legacy flag
    # once the newer ``fp32_precision`` has set it otherwise
    try:
        name, value, prev = "allow_tf32", False, matmul.allow_tf32
    except RuntimeError:
        name, value, prev = "fp32_precision", "ieee", matmul.fp32_precision
    setattr(matmul, name, value)
    try:
        yield
    finally:
        setattr(matmul, name, prev)


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


def masked_softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """softmax along ``dim`` where all--inf rows give zeros, not NaN
    (exp(-inf) / 0 is defined as 0)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(x - m_safe)
    s = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.where(s == 0.0, torch.ones_like(s), s)
