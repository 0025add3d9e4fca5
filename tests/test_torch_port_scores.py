"""The PyTorch port's ASG scores and forward loss against the JAX package.

Same inputs, made with numpy from a seed, go through ``torch_asg_tpu``
(Pallas kernels in interpret mode on the CPU) and ``torch_asg_tpu_torch``
(each kernel's plain version, which CPU tensors run).  Everything is fp64;
the tolerance is ``tests/test_fused.py``'s, 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops import fac as jfac
from torch_asg_tpu.ops.pallas import asg_kernels as jkern
from torch_asg_tpu_torch.ops import fac as pfac
from torch_asg_tpu_torch.ops.kernels import asg_kernels as pkern
from torch_asg_tpu_torch.ops.kernels.common import use_kernel

TOL = dict(rtol=1e-10, atol=1e-10)


def _case(seed, t_total, num_batches, s_total, num_labels, ragged=True):
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    if ragged:
        li = rng.integers(max(s_total, t_total // 2), t_total + 1, size=num_batches)
        lo = rng.integers(1, s_total + 1, size=num_batches)
    else:
        li = np.full(num_batches, t_total)
        lo = np.full(num_batches, s_total)
    return trans, inputs, targets, li.astype(np.int32), lo.astype(np.int32)


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("shape", [(13, 3, 5, 7), (37, 5, 9, 11)])
def test_scores_match_jax(shape, ragged):
    case = _case(1, *shape, ragged=ragged)
    want_fused = jx.asg_scores(*_jax(*case), impl="fused")
    want_scan = jx.asg_scores(*_jax(*case), impl="scan")
    for impl in ("fused", "scan"):
        got = pt.asg_scores(*_torch(*case), impl=impl)
        for g, wf, ws in zip(got, want_fused, want_scan):
            np.testing.assert_allclose(g.numpy(), np.asarray(wf), **TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(ws), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_loss_reductions_match_jax(reduction):
    case = _case(2, 13, 3, 5, 7)
    want = jx.asg_loss(*_jax(*case), reduction=reduction)
    got = pt.asg_loss(*_torch(*case), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_module_matches_jax_kernel():
    """``ops.kernels.asg_kernels.asg_scores_fused`` (plain version on CPU)
    against the Pallas kernel it replaces, run in interpret mode."""
    case = _case(3, 13, 3, 5, 7)
    want = jkern.asg_scores_fused(*_jax(*case))
    got = pkern.asg_scores_fused(*_torch(*case))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_make_aligned_matches_jax():
    trans, inputs, targets, li, lo = _case(4, 13, 3, 5, 7)
    trans[1, 2] = -np.inf
    targets[0, :3] = [2, 1, 2]
    targets[1, 0] = -4  # clipped to 0
    targets[2, 1] = 99  # clipped to N-1
    want = jfac.make_aligned(*_jax(trans, inputs, targets, li, lo))
    got = pfac.make_aligned(*_torch(trans, inputs, targets, li, lo))
    np.testing.assert_array_equal(got.inputs.numpy(), np.asarray(want.inputs))
    np.testing.assert_array_equal(got.self_trans.numpy(), np.asarray(want.self_trans))
    np.testing.assert_array_equal(got.next_trans.numpy(), np.asarray(want.next_trans))
    np.testing.assert_array_equal(got.targets.numpy(), np.asarray(want.targets))


def test_lattice_scores_match_jax():
    trans, inputs, targets, li, lo = _case(5, 13, 3, 5, 7)
    np.testing.assert_allclose(
        pt.fcc_score(*_torch(trans, inputs, li)).numpy(),
        np.asarray(jx.fcc_score(*_jax(trans, inputs, li))), **TOL)
    np.testing.assert_allclose(
        pt.fac_score(*_torch(trans, inputs, targets, li, lo)).numpy(),
        np.asarray(jx.fac_score(*_jax(trans, inputs, targets, li, lo))), **TOL)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_degenerate_lengths(impl):
    """L_in = 1, L_out = 1 and an unalignable element (L_out > L_in): the
    last gives +inf loss, never NaN."""
    trans, inputs, targets, _, _ = _case(6, 13, 3, 5, 7)
    li = np.array([1, 13, 2], np.int32)
    lo = np.array([1, 1, 4], np.int32)
    want = jx.asg_loss(*_jax(trans, inputs, targets, li, lo), reduction="none",
                       impl="fused")
    got = pt.asg_loss(*_torch(trans, inputs, targets, li, lo), reduction="none",
                      impl=impl).numpy()
    assert not np.isnan(got).any()
    assert got[2] == np.inf
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_neg_inf_transitions(impl):
    trans, inputs, targets, li, lo = _case(7, 13, 3, 5, 7)
    trans[np.random.default_rng(7).random(trans.shape) < 0.3] = -np.inf
    want = jx.asg_scores(*_jax(trans, inputs, targets, li, lo), impl="scan")
    got = pt.asg_scores(*_torch(trans, inputs, targets, li, lo), impl=impl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_out_of_range_targets_clip():
    trans, inputs, targets, li, lo = _case(8, 13, 3, 5, 7)
    targets[0, 1] = -3
    targets[1, 0] = 7
    targets[2, 2] = 1000
    want = jx.asg_loss(*_jax(trans, inputs, targets, li, lo), reduction="none")
    got = pt.asg_loss(*_torch(trans, inputs, targets, li, lo), reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_targets_longer_than_input_clamp():
    trans, inputs, targets, _, _ = _case(9, 6, 3, 9, 7, ragged=False)
    li = np.array([6, 4, 6], np.int32)
    lo = np.array([9, 3, 7], np.int32)
    want = jx.asg_loss(*_jax(trans, inputs, targets, li, lo), reduction="none")
    got = pt.asg_loss(*_torch(trans, inputs, targets, li, lo), reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_golden_losses(impl):
    args = _torch(np.zeros((golden.N, golden.N)), golden.INPUTS_TBN,
                  golden.TARGETS, golden.INPUT_LENGTHS, golden.TARGET_LENGTHS)
    loss = pt.asg_loss(*args, reduction="none", impl=impl).numpy()
    assert np.abs(loss - golden.EXPECTED_LOSS).sum() < 1e-3


def test_spread_guard():
    """Past the 60-nat finite spread: 'auto' reroutes to the log-domain scan
    tier and matches JAX; explicit 'fused' raises in both packages;
    validate=False skips the check."""
    trans, inputs, targets, li, lo = _case(10, 13, 3, 5, 7)
    trans[0, 0] = 40.0
    trans[1, 2] = -40.0
    want = jx.asg_loss(*_jax(trans, inputs, targets, li, lo), reduction="none")
    want_scan = jx.asg_loss(*_jax(trans, inputs, targets, li, lo),
                            reduction="none", impl="scan")
    got = pt.asg_loss(*_torch(trans, inputs, targets, li, lo), reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_scan), **TOL)
    with pytest.raises(ValueError, match="spread"):
        jx.asg_loss(*_jax(trans, inputs, targets, li, lo), impl="fused")
    with pytest.raises(ValueError, match="spread"):
        pt.asg_loss(*_torch(trans, inputs, targets, li, lo), impl="fused")
    rerouted = pt.asg_loss(*_torch(trans, inputs, targets, li, lo),
                           reduction="none", impl="fused", validate="reroute")
    np.testing.assert_allclose(rerouted.numpy(), np.asarray(want_scan), **TOL)
    pt.asg_loss(*_torch(trans, inputs, targets, li, lo), impl="fused",
                validate=False)


def test_impl_contract():
    trans, inputs, targets, li, lo = _torch(*_case(12, 6, 2, 3, 5))
    for impl, err in (("pallas", NotImplementedError), ("matmul", NotImplementedError),
                      ("bogus", ValueError)):
        with pytest.raises(err, match=impl):
            pt.asg_loss(trans, inputs, targets, li, lo, impl=impl)
    with pytest.raises(ValueError, match="reduction"):
        pt.asg_loss(trans, inputs, targets, li, lo, reduction="avg")
    wide = torch.zeros((2, 2, 513), dtype=torch.float64)
    with pytest.raises(ValueError, match="512"):
        pt.asg_loss(torch.zeros((513, 513), dtype=torch.float64), wide,
                    targets, impl="fused")
    with pytest.raises(NotImplementedError, match="matmul"):
        pt.asg_loss(torch.zeros((513, 513), dtype=torch.float64), wide, targets)


def test_half_precision_inputs_upcast():
    trans, inputs, targets, li, lo = _case(13, 8, 2, 3, 5)
    half = torch.from_numpy(inputs).to(torch.bfloat16)
    got = pt.asg_loss(torch.from_numpy(trans).float(), half, *_torch(targets, li, lo),
                      reduction="none")
    assert got.dtype == torch.float32
    want = pt.asg_loss(torch.from_numpy(trans).float(), half.float(),
                       *_torch(targets, li, lo), reduction="none")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dispatch_rule():
    assert use_kernel(torch.zeros(1), torch.zeros(1)) is False
    with pytest.raises(ValueError, match="device"):
        use_kernel(torch.zeros(1, device="meta"))


def test_input_lengths_outside_range_match_jax():
    """An element whose L_in lies outside [1, T] is never seeded: every tier
    of both packages scores it -inf, and the other elements are untouched."""
    trans, inputs, targets, li, lo = _case(14, 13, 4, 5, 7)
    li[1], li[2] = 0, 14
    want = jx.asg_scores(*_jax(trans, inputs, targets, li, lo), impl="fused")
    for impl in ("fused", "scan"):
        got = pt.asg_scores(*_torch(trans, inputs, targets, li, lo), impl=impl)
        for g, w in zip(got, want):
            assert (g[1:3] == -np.inf).all()
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
