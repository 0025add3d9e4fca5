"""The port's ``ASGLoss`` module against the JAX package's torch module
(``torch_asg_tpu.torch_compat.ASGLoss``, the reference's eval-mode contract:
``tests/test_torch_compat.py::test_eval_mode_backward_raises_like_reference``),
and the rule that picks K1's route.

The same inputs, made with numpy from a seed, go through both modules: the
port's at fp64 on CPU tensors (the kernels' plain versions), the JAX
package's at fp32, as its own tests run it; losses agree to rtol 1e-5 (the
fp32 side's rounding over 6 frames).  Within the port, eval and train
losses come from the same arithmetic and agree to 1e-12.
"""

import numpy as np
import pytest
import torch

import torch_asg_tpu_torch as pt
from test_torch_port_grads import _counting
from torch_asg_tpu.torch_compat import ASGLoss as RefASGLoss
from torch_asg_tpu_torch.ops.kernels import asg_kernels as pkern
from torch_asg_tpu_torch.ops.kernels import common as kcommon
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES

REF_TOL = dict(rtol=1e-5)
SAME_TOL = dict(rtol=1e-12)


def _case(seed=7, t_total=6, num_batches=2, s_total=3, num_labels=5):
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total))
    li = np.asarray([t_total, t_total - 1], np.int64)
    lo = np.asarray([s_total, s_total - 1], np.int64)
    return trans, inputs, targets, li, lo


def _port_module(trans, **kwargs):
    crit = pt.ASGLoss(trans.shape[0], device="cpu", dtype=torch.float64, **kwargs)
    with torch.no_grad():
        crit.transition.copy_(torch.from_numpy(trans))
    return crit


def _reference_loss(trans, inputs, targets, li, lo, **kwargs):
    """The JAX package's torch module in eval mode, fp32."""
    ref = RefASGLoss(num_labels=trans.shape[0], **kwargs).eval()
    with torch.no_grad():
        ref.transition.copy_(torch.from_numpy(trans).float())
    out = ref(torch.from_numpy(inputs).float(), *map(torch.from_numpy, (targets, li, lo)))
    assert not out.requires_grad
    return float(out)


def test_eval_mode_backward_raises_like_reference():
    trans, inputs, targets, li, lo = _case()
    crit = _port_module(trans)
    t_in = torch.from_numpy(inputs).requires_grad_(True)
    args = (t_in, *map(torch.from_numpy, (targets, li, lo)))

    crit.eval()
    loss_eval = crit(*args)
    assert not loss_eval.requires_grad
    with pytest.raises(RuntimeError):
        loss_eval.backward()

    crit.train()
    loss_train = crit(*args)
    assert loss_train.requires_grad
    np.testing.assert_allclose(float(loss_eval), float(loss_train.detach()), **SAME_TOL)
    np.testing.assert_allclose(float(loss_eval),
                               _reference_loss(trans, inputs, targets, li, lo), **REF_TOL)


def test_forward_only_is_always_eval():
    trans, inputs, targets, li, lo = _case(8)
    crit = _port_module(trans, forward_only=True)
    assert crit.training
    t_in = torch.from_numpy(inputs).requires_grad_(True)
    out = crit(t_in, *map(torch.from_numpy, (targets, li, lo)))
    assert not out.requires_grad
    with pytest.raises(RuntimeError):
        out.backward()
    train = _port_module(trans)(t_in, *map(torch.from_numpy, (targets, li, lo)))
    np.testing.assert_allclose(float(out), float(train.detach()), **SAME_TOL)


def test_gpu_no_stream_impl_is_the_fourth_argument():
    """``ASGLoss(5, 'mean', False, True)`` runs the scan tier, as the
    reference's; ``impl`` and the other knobs are keyword-only."""
    trans, inputs, targets, li, lo = _case(9)
    crit = pt.ASGLoss(5, "mean", False, True, device="cpu", dtype=torch.float64)
    assert crit.impl == "scan" == RefASGLoss(5, "mean", False, True).impl
    assert _port_module(trans).impl == "auto"
    assert _port_module(trans, gpu_no_stream_impl=True, impl="fused").impl == "fused"
    with pytest.raises(TypeError):
        pt.ASGLoss(5, "mean", False, False, "scan")
    with torch.no_grad():
        crit.transition.copy_(torch.from_numpy(trans))
    args = (torch.from_numpy(inputs), *map(torch.from_numpy, (targets, li, lo)))
    want = pt.asg_loss(crit.transition.detach(), *args, impl="scan")
    np.testing.assert_allclose(float(crit(*args).detach()), float(want), **SAME_TOL)
    np.testing.assert_allclose(
        float(want), _reference_loss(trans, inputs, targets, li, lo, gpu_no_stream_impl=True),
        **REF_TOL)


def test_eval_mode_launches_the_storeless_kernel(monkeypatch):
    """On the kernel route (wrappers swapped for counting plain versions, as
    test_torch_port_grads.py does) an eval-mode call launches K1 without
    stores once and K1 with stores never; a train-mode call the store
    variant and, on backward, K2."""
    calls = _counting(monkeypatch)
    trans, inputs, targets, li, lo = _case(10)
    crit = _port_module(trans).eval()
    t_in = torch.from_numpy(inputs).requires_grad_(True)
    args = (t_in, *map(torch.from_numpy, (targets, li, lo)))
    crit(*args)
    assert calls == {"_fwd_scores_kernel": 1, "_fwd_store_kernel": 0, "_bwd_kernel": 0}
    crit.train()
    crit(*args).backward()
    assert calls == {"_fwd_scores_kernel": 1, "_fwd_store_kernel": 1, "_bwd_kernel": 1}


@pytest.mark.parametrize("num_labels, s_total, route", [
    (30, 50, "warp"), (32, 32, "warp"), (64, 65, "warp"), (128, 128, "warp"),
    (129, 10, "block"), (10, 129, "block"), (512, 512, "block"),
])
def test_fwd_route_rule(num_labels, s_total, route):
    assert kcommon.width_route(max(num_labels, s_total)) == route


def _kernel_args(num_labels, s_total, seed=11):
    trans, inputs, targets, li, lo = _case(seed, t_total=max(6, s_total), s_total=s_total,
                                           num_labels=num_labels)
    trans, inputs = torch.from_numpy(trans), torch.from_numpy(inputs)
    lat, e, _ = pkern._prepare(trans, inputs, torch.from_numpy(targets),
                               torch.from_numpy(li), torch.from_numpy(lo))
    return (e, lat.self_trans.contiguous(), lat.next_trans.contiguous(), inputs,
            lat.inputs.contiguous(), torch.from_numpy(li), torch.from_numpy(lo))


def _recording_launches(monkeypatch):
    """Replace the launch with a record of its (variant, route)."""
    launched = []
    monkeypatch.setattr(pkern, "_launch_fwd",
                        lambda variant, route, *args: launched.append((variant, route)))
    return launched


@pytest.mark.parametrize("wrapper", ["_fwd_scores_kernel", "_fwd_store_kernel"])
def test_bad_route_raises_before_any_launch(monkeypatch, wrapper):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = getattr(pkern, wrapper)
    with pytest.raises(ValueError, match="unknown K1 route"):
        fn(*_kernel_args(5, 3), route="grid")
    with pytest.raises(ValueError, match="warp route"):
        fn(*_kernel_args(129, 3), route="warp")
    assert launched == [] and not LAUNCHES


@pytest.mark.parametrize("wrapper, variant", [("_fwd_scores_kernel", "scores"),
                                              ("_fwd_store_kernel", "store")])
def test_route_dispatch_and_counts(monkeypatch, wrapper, variant):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger under the variant's id (K1 without stores, K1s
    with), by route beside its total."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = getattr(pkern, wrapper)
    kernel = "K1" if variant == "scores" else "K1s"
    fn(*_kernel_args(30, 5))
    fn(*_kernel_args(130, 5))
    fn(*_kernel_args(30, 5), route="block")
    assert launched == [(variant, "warp"), (variant, "block"), (variant, "block")]
    assert LAUNCHES == {kernel: 3, f"{kernel}.warp": 1, f"{kernel}.block": 2}
