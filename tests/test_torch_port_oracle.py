"""The port against the independent PyTorch-autograd oracle
(``tests/oracle.py``), on randomized ragged shapes, for every ``impl``.

The oracle computes scores by plain forward recursions and gradients by
autograd, sharing no structure with the port, so agreement is evidence on
arbitrary shapes.  ``tests/test_parity_torch.py`` holds the JAX package to
it; this file holds the port, on CPU tensors at fp64 (the kernels' plain
versions), at that file's tolerances.  The default dtype is set to float64
for the oracle and restored after each test.
"""

import numpy as np
import pytest
import torch

from oracle import asg_oracle, fac_oracle, fcc_oracle
from torch_asg_tpu_torch import asg_loss, fac_score, fcc_score
from torch_asg_tpu_torch.asg import IMPLS
from torch_asg_tpu_torch.ops.fcc import fcc_score_matmul
from torch_asg_tpu_torch.ops.kernels.fac_kernels import fac_score_pallas
from torch_asg_tpu_torch.ops.kernels.fcc_kernels import fcc_score_pallas


@pytest.fixture(autouse=True)
def _torch_f64_default():
    """fp64 default for the oracle, scoped and restored, so it leaks into no
    later test."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _case(seed, T, B, S, N, ragged=True):
    r = np.random.default_rng(seed)
    inputs = r.normal(size=(T, B, N))
    trans = r.normal(size=(N, N))
    targets = r.integers(0, N, size=(B, S))
    if ragged:
        input_lengths = r.integers(max(1, S), T + 1, size=(B,))
        target_lengths = r.integers(1, S + 1, size=(B,))
    else:
        input_lengths = np.full((B,), T)
        target_lengths = np.full((B,), S)
    return inputs, trans, targets, input_lengths, target_lengths


FCC_IMPLS = {"scan": fcc_score, "matmul": fcc_score_matmul, "pallas": fcc_score_pallas}
FAC_IMPLS = {"scan": fac_score, "pallas": fac_score_pallas}


@pytest.mark.parametrize("impl", sorted(FCC_IMPLS))
@pytest.mark.parametrize("seed", range(4))
def test_fcc_parity(seed, impl):
    inputs, trans, _, li, _ = _case(seed, T=9, B=4, S=3, N=6)
    got = FCC_IMPLS[impl](torch.tensor(trans), torch.tensor(inputs), torch.tensor(li))
    want = fcc_oracle(torch.tensor(trans), torch.tensor(inputs), li)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("impl", sorted(FAC_IMPLS))
@pytest.mark.parametrize("seed", range(4))
def test_fac_parity(seed, impl):
    inputs, trans, targets, li, lo = _case(seed, T=9, B=4, S=4, N=6)
    got = FAC_IMPLS[impl](*map(torch.tensor, (trans, inputs, targets, li, lo)))
    want = fac_oracle(torch.tensor(trans), torch.tensor(inputs), torch.tensor(targets), li, lo)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ragged", [False, True])
def test_asg_loss_and_grad_parity(seed, ragged, impl):
    inputs, trans, targets, li, lo = _case(seed, T=8, B=3, S=4, N=5, ragged=ragged)
    tr = torch.tensor(trans, requires_grad=True)
    x = torch.tensor(inputs, requires_grad=True)
    lengths = (torch.tensor(targets), torch.tensor(li), torch.tensor(lo))
    got = asg_loss(tr, x, *lengths, reduction="none", impl=impl)
    g_tr, g_x = torch.autograd.grad(got.sum(), (tr, x))

    o_tr = torch.tensor(trans, requires_grad=True)
    o_x = torch.tensor(inputs, requires_grad=True)
    want = asg_oracle(o_tr, o_x, torch.tensor(targets), li, lo)
    want.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(g_tr.numpy(), o_tr.grad.numpy(), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(g_x.numpy(), o_x.grad.numpy(), rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("impl", IMPLS)
def test_asg_parity_bigger_shape(impl):
    """A letter-vocabulary case closer to the serving shape."""
    inputs, trans, targets, li, lo = _case(7, T=50, B=4, S=12, N=30)
    got = asg_loss(*map(torch.tensor, (trans, inputs, targets, li, lo)), reduction="none",
                   impl=impl)
    want = asg_oracle(torch.tensor(trans), torch.tensor(inputs), torch.tensor(targets), li, lo)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)


def test_default_dtype_is_restored():
    """Inside a test the oracle's float64 default holds; the fixture puts
    the previous default back after."""
    assert torch.get_default_dtype() == torch.float64
