"""The PyTorch port's ASG gradients against the JAX package's.

Same inputs, made with numpy from a seed, go through ``torch_asg_tpu``
(Pallas kernels in interpret mode on the CPU) and ``torch_asg_tpu_torch``
(each kernel's plain version, which CPU tensors run), both at fp64.
Tolerances: ``tests/test_fused.py``'s rtol 1e-9 / atol 1e-12 for gradients,
1e-10 for values; the golden constants at ``tests/test_golden.py``'s 1e-4.
"""

import jax
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

GRAD_TOL = dict(rtol=1e-9, atol=1e-12)
VALUE_TOL = dict(rtol=1e-10, atol=1e-10)


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


def _port_grads(fn, trans, inputs):
    """(value, d/d transition, d/d inputs) of the port's scalar ``fn``."""
    t = torch.tensor(trans, requires_grad=True)
    i = torch.tensor(inputs, requires_grad=True)
    out = fn(t, i)
    gt, gi = torch.autograd.grad(out, (t, i))
    return out.detach().numpy(), gt.numpy(), gi.numpy()


def _jax_grads(fn, trans, inputs):
    out, (gt, gi) = jax.jit(jax.value_and_grad(fn, (0, 1)))(*_jax(trans, inputs))
    return np.asarray(out), np.asarray(gt), np.asarray(gi)


def _assert_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], **VALUE_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_fcc_grad_matches_jax(ragged):
    """test_grads.py's full-length (T, B, N = 8, 2, 3) and ragged
    (6, 3, 7; lengths 6, 3, 1) cases."""
    rng = np.random.default_rng(0)
    if ragged:
        inputs, trans = rng.normal(size=(6, 3, 7)), rng.uniform(size=(7, 7))
        li = np.array([6, 3, 1], np.int32)
    else:
        inputs, trans = rng.uniform(size=(8, 2, 3)), rng.uniform(size=(3, 3))
        li = np.array([8, 8], np.int32)
    got = _port_grads(lambda t, i: pt.fcc_score(t, i, torch.from_numpy(li)).sum(),
                      trans, inputs)
    want = _jax_grads(lambda t, i: jx.fcc_score(t, i, jnp.asarray(li)).sum(),
                      trans, inputs)
    _assert_grads(got, want)


def test_fac_grad_ragged_matches_jax():
    rng = np.random.default_rng(1)
    inputs, trans = rng.uniform(size=(5, 3, 3)), rng.uniform(size=(3, 3))
    targets = np.array([[1, 2, 1], [0, 1, 0], [1, 0, 0]], np.int32)
    li = np.array([5, 4, 2], np.int32)
    lo = np.array([3, 2, 1], np.int32)
    got = _port_grads(lambda t, i: pt.fac_score(t, i, *_torch(targets, li, lo)).sum(),
                      trans, inputs)
    want = _jax_grads(lambda t, i: jx.fac_score(t, i, *_jax(targets, li, lo)).sum(),
                      trans, inputs)
    _assert_grads(got, want)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_asg_grad_mean_reduction_matches_jax(impl):
    """test_grads.py::test_asg_grad_mean_reduction: default lengths."""
    rng = np.random.default_rng(2)
    inputs, trans = rng.normal(size=(4, 3, 4)), rng.uniform(size=(4, 4))
    targets = rng.integers(0, 4, size=(3, 2)).astype(np.int32)
    got = _port_grads(lambda t, i: pt.asg_loss(t, i, torch.from_numpy(targets),
                                               reduction="mean", impl=impl),
                      trans, inputs)
    want = _jax_grads(lambda t, i: jx.asg_loss(t, i, jnp.asarray(targets),
                                               reduction="mean"),
                      trans, inputs)
    _assert_grads(got, want)


@pytest.mark.parametrize("shape", [(13, 3, 5, 7), (26, 4, 6, 9)])
def test_fused_grads_match_oracle(shape):
    """test_fused.py::test_fused_grads_match_oracle: the port's fused tier
    (K1 with stores + K2, plain versions) against the JAX fused kernels and
    against the JAX scan oracle; the port's scan tier against the same."""
    trans, inputs, targets, li, lo = _case(3, *shape)

    def port(impl):
        def loss(t, i):
            return pt.asg_loss(t, i, *_torch(targets, li, lo), reduction="sum", impl=impl)
        return loss

    def jax_fused(t, i):
        f, a = jkern.asg_scores_fused(t, i, *_jax(targets, li, lo))
        return (f - a).sum()

    def jax_scan(t, i):
        return (jx.fcc_score(t, i, jnp.asarray(li))
                - jx.fac_score(t, i, *_jax(targets, li, lo))).sum()

    want_fused = _jax_grads(jax_fused, trans, inputs)
    want_scan = _jax_grads(jax_scan, trans, inputs)
    for impl in ("fused", "scan"):
        got = _port_grads(port(impl), trans, inputs)
        _assert_grads(got, want_fused)
        _assert_grads(got, want_scan)


def test_fused_forward_only_matches_vjp_path():
    """The store-less call (no gradient) and the differentiated call give
    the same scores."""
    trans, inputs, targets, li, lo = _torch(*_case(4, 17, 3, 5, 7))
    plain = pkern.asg_scores_fused(trans, inputs, targets, li, lo)
    t = trans.clone().requires_grad_(True)
    with_grad = pkern.asg_scores_fused(t, inputs, targets, li, lo)
    assert with_grad[0].requires_grad
    for p, g in zip(plain, with_grad):
        np.testing.assert_allclose(p.numpy(), g.detach().numpy(), **VALUE_TOL)


def test_forward_only_value_matches_grad_path():
    """test_grads.py's: the loss of a plain call equals the loss of a
    differentiated one, for both tiers."""
    trans, inputs, targets, _, _ = _case(5, 7, 3, 4, 5)
    li, lo = np.array([7, 5, 2], np.int32), np.array([4, 2, 1], np.int32)
    args = _torch(targets, li, lo)
    for impl in ("fused", "scan"):
        plain = pt.asg_loss(*_torch(trans, inputs), *args, reduction="sum", impl=impl)
        via_grad = _port_grads(lambda t, i: pt.asg_loss(t, i, *args, reduction="sum",
                                                        impl=impl), trans, inputs)[0]
        np.testing.assert_allclose(plain.numpy(), via_grad, rtol=1e-12)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_degenerate_length_grads_match_jax(impl):
    """test_fused.py::test_fused_degenerate_lengths: L_in = 1 and L_out = 1
    corners give finite gradients equal to the JAX fused kernels'."""
    trans, inputs, targets, _, _ = _case(6, 9, 3, 4, 6)
    li, lo = np.array([1, 9, 4], np.int32), np.array([1, 1, 4], np.int32)
    got = _port_grads(lambda t, i: pt.asg_loss(t, i, *_torch(targets, li, lo),
                                               reduction="sum", impl=impl),
                      trans, inputs)
    want = _jax_grads(lambda t, i: jx.asg_loss(t, i, *_jax(targets, li, lo),
                                               reduction="sum", impl="fused"),
                      trans, inputs)
    assert np.isfinite(got[1]).all() and np.isfinite(got[2]).all()
    _assert_grads(got, want)


def test_unalignable_and_unseeded_elements_get_no_gradient():
    """L_out > L_in scores an aligned -inf (loss +inf) and L_in outside
    [1, T] has no path (both scores -inf): the fused tier still gives finite
    gradients, exactly 0 on the emissions of elements without a path, and
    equal to the scan tier's everywhere."""
    trans, inputs, targets, _, _ = _case(7, 9, 5, 4, 6)
    li, lo = np.array([9, 3, 0, 10, 6], np.int32), np.array([4, 4, 2, 2, 3], np.int32)
    grads = {}
    for impl in ("fused", "scan"):
        t = torch.tensor(trans, requires_grad=True)
        i = torch.tensor(inputs, requires_grad=True)
        loss = pt.asg_loss(t, i, *_torch(targets, li, lo), reduction="none", impl=impl)
        assert loss[1] == np.inf
        grads[impl] = [g.numpy() for g in
                       torch.autograd.grad(loss, (t, i), torch.ones_like(loss))]
    for g, w in zip(grads["fused"], grads["scan"]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    assert (grads["fused"][1][:, 2:4] == 0).all()


def test_neg_inf_transitions_grads_match_jax():
    trans, inputs, targets, li, lo = _case(8, 11, 3, 4, 6)
    trans[np.random.default_rng(8).random(trans.shape) < 0.3] = -np.inf
    for impl in ("fused", "scan"):
        got = _port_grads(lambda t, i: pt.asg_loss(t, i, *_torch(targets, li, lo),
                                                   reduction="sum", impl=impl),
                          trans, inputs)
        want = _jax_grads(lambda t, i: jx.asg_loss(t, i, *_jax(targets, li, lo),
                                                   reduction="sum", impl="scan"),
                          trans, inputs)
        assert np.isfinite(got[1]).all()
        _assert_grads(got, want)


def test_temperature_grads_match_jax():
    trans, inputs, targets, li, lo = _case(9, 10, 2, 3, 5)
    got = _port_grads(lambda t, i: pt.asg_loss(t, i, *_torch(targets, li, lo),
                                               temperature=0.5),
                      trans, inputs)
    want = _jax_grads(lambda t, i: jx.asg_loss(t, i, *_jax(targets, li, lo),
                                               temperature=0.5),
                      trans, inputs)
    _assert_grads(got, want)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_gradcheck(impl):
    """Finite differences against the custom backward, fp64, tiny shape."""
    trans, inputs, targets, li, lo = _case(10, 6, 2, 3, 4)
    args = _torch(targets, li, lo)

    def scores(t, i):
        return torch.stack(pt.asg_scores(t, i, *args, impl=impl))

    assert torch.autograd.gradcheck(
        scores, (torch.tensor(trans, requires_grad=True),
                 torch.tensor(inputs, requires_grad=True)))


def _golden_args():
    return _torch(golden.INPUTS_TBN, golden.TARGETS, golden.INPUT_LENGTHS,
                  golden.TARGET_LENGTHS)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_golden_grads(impl):
    inputs, targets, li, lo = _golden_args()
    trans = torch.zeros((golden.N, golden.N), dtype=torch.float64, requires_grad=True)
    inputs.requires_grad_(True)
    loss = pt.asg_loss(trans, inputs, targets, li, lo, reduction="none", impl=impl)
    grad_t, grad_i = torch.autograd.grad(loss.sum(), (trans, inputs))
    assert np.abs(grad_i.numpy() - golden.EXPECTED_INPUT_GRAD_TBN).max() < 1e-4
    assert np.abs(grad_t.numpy() - golden.EXPECTED_TRANS_GRAD).max() < 1e-4


def test_golden_module_api():
    """``ASGLoss``: a zero-initialised transition parameter that trains."""
    crit = pt.ASGLoss(golden.N, reduction="none", device="cpu", dtype=torch.float64)
    assert isinstance(crit.transition, torch.nn.Parameter)
    assert (crit.transition == 0).all()
    inputs, targets, li, lo = _golden_args()
    loss = crit(inputs, targets, li, lo)
    assert np.abs(loss.detach().numpy() - golden.EXPECTED_LOSS).sum() < 1e-3
    loss.sum().backward()
    assert np.abs(crit.transition.grad.numpy() - golden.EXPECTED_TRANS_GRAD).max() < 1e-4
    with pytest.raises(ValueError, match="reduction"):
        pt.ASGLoss(golden.N, reduction="avg", device="cpu")


def test_forward_only_module_keeps_no_graph():
    crit = pt.ASGLoss(golden.N, forward_only=True, device="cpu", dtype=torch.float64)
    inputs, targets, li, lo = _golden_args()
    inputs.requires_grad_(True)
    loss = crit(inputs, targets, li, lo)
    assert not loss.requires_grad
    np.testing.assert_allclose(loss.numpy(), golden.EXPECTED_LOSS.mean(), atol=1e-3)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_determinism(impl):
    """The same call twice gives bit-identical gradients."""
    inputs, targets, li, lo = _golden_args()
    trans = torch.zeros((golden.N, golden.N), dtype=torch.float64)
    runs = [_port_grads(lambda t, i: pt.asg_loss(t, i, targets, li, lo, impl=impl),
                        trans.numpy(), inputs.numpy()) for _ in range(2)]
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


def _counting(monkeypatch):
    """Make every tensor take the kernel route, with each kernel wrapper
    replaced by its plain version plus a launch count."""
    monkeypatch.setattr(pkern, "use_kernel", lambda *tensors: True)
    calls = {}
    for name, plain in (("_fwd_scores_kernel", pkern._fwd_scores_plain),
                        ("_fwd_store_kernel", pkern._fwd_store_plain),
                        ("_bwd_kernel", pkern._bwd_plain)):
        calls[name] = 0

        def spy(*args, name=name, plain=plain):
            calls[name] += 1
            return plain(*args)

        monkeypatch.setattr(pkern, name, spy)
    return calls


def test_forward_only_calls_launch_the_storeless_kernel(monkeypatch):
    """A call that autograd will not differentiate goes to K1 without stores
    and never to the store variant or K2; a differentiated call goes to the
    store variant and K2, never to K1 without stores."""
    calls = _counting(monkeypatch)
    trans, inputs, targets, li, lo = _torch(*_case(11, 9, 2, 3, 5))
    inputs.requires_grad_(True)
    with torch.no_grad():
        pt.asg_loss(trans, inputs, targets, li, lo)
    pt.asg_scores(trans, inputs.detach(), targets, li, lo)
    assert calls == {"_fwd_scores_kernel": 2, "_fwd_store_kernel": 0, "_bwd_kernel": 0}
    pt.asg_loss(trans, inputs, targets, li, lo).backward()
    assert calls == {"_fwd_scores_kernel": 2, "_fwd_store_kernel": 1, "_bwd_kernel": 1}


def test_scatter_to_full_past_onehot_matches_jax():
    """The arm past _ONEHOT_MAX_LABELS (a loop over slots for the emissions,
    the one-hot product over the labels that occur for the transition)
    against JAX's scatter-add arm, with labels repeated within and across
    batch elements."""
    rng = np.random.default_rng(12)
    t_total, num_batches, s_total, num_labels = 5, 3, 4, 520
    tgt = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    tgt[0, :2] = tgt[1, 1]
    tgt[2, 3] = tgt[2, 0]
    g_aligned = rng.normal(size=(t_total, num_batches, s_total))
    g_self, g_next = rng.normal(size=(num_batches, s_total)), rng.normal(size=(num_batches, s_total))
    lat_j = jfac.AlignedLattice(None, None, None, jnp.asarray(tgt), None)
    want = jfac.scatter_to_full(lat_j, *_jax(g_aligned, g_self, g_next), num_labels)
    lat_p = pfac.AlignedLattice(None, None, None, torch.from_numpy(tgt).long())
    got = pfac.scatter_to_full(lat_p, *_torch(g_aligned, g_self, g_next), num_labels)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    # the one-hot arm gives the same on the same slots at a narrower width
    narrow = np.minimum(tgt, 511)
    lat_n = pfac.AlignedLattice(None, None, None, torch.from_numpy(narrow).long())
    wide = pfac.scatter_to_full(lat_n, *_torch(g_aligned, g_self, g_next), 513)
    small = pfac.scatter_to_full(lat_n, *_torch(g_aligned, g_self, g_next), 512)
    np.testing.assert_allclose(wide[0][:512, :512].numpy(), small[0].numpy(), **GRAD_TOL)
    np.testing.assert_allclose(wide[1][..., :512].numpy(), small[1].numpy(), **GRAD_TOL)


def test_bwd_plain_matches_jax_kernel_outputs():
    """K2's plain version against the Pallas backward kernel it replaces
    (interpret mode), on the same residuals: every gradient of the fused
    tier before ``scatter_to_full``."""
    trans, inputs, targets, li, lo = _case(13, 11, 3, 4, 6)
    g_full, g_fac = np.array([1.0, 0.5, -2.0]), np.array([-1.0, 0.25, 3.0])
    (_, ip, ap, e, e_t, self_p, next_p, li_col, lo_col, _, dims) = jkern._prepare(
        *_jax(trans, inputs, targets, li, lo))
    t_total, num_batches, num_labels, s_total, b_pad, n_pad, s_pad = dims
    pb, qb, _, _ = jkern._run_fwd(li_col, lo_col, e, self_p, next_p, ip, ap,
                                  (num_labels, n_pad, s_pad), store=True)
    gcol = [jkern.pad_axis(jnp.asarray(g), b_pad, 0, 0.0)[:, None] for g in (g_full, g_fac)]
    want = jkern._run_bwd(li_col, *gcol, e, e_t, self_p, next_p, ip, ap, pb, qb,
                          (num_labels, n_pad, s_pad))
    want = [np.asarray(want[0])[:t_total, :num_batches, :num_labels],
            np.asarray(want[1])[:t_total, :num_batches, :s_total],
            np.asarray(want[2])[:num_labels, :num_labels],
            np.asarray(want[3])[:num_batches, :s_total],
            np.asarray(want[4])[:num_batches, :s_total]]

    p_lat, p_e, _ = pkern._prepare(*_torch(trans, inputs, targets, li, lo))
    args = (p_e, p_lat.self_trans, p_lat.next_trans, torch.from_numpy(inputs),
            p_lat.inputs, *_torch(li, lo))
    p_pb, p_qb, _, _ = pkern._fwd_store_plain(*args)
    np.testing.assert_allclose(p_pb.numpy(), np.asarray(pb)[:t_total, :num_batches], **GRAD_TOL)
    np.testing.assert_allclose(p_qb.numpy(), np.asarray(qb)[:t_total, :num_batches], **GRAD_TOL)
    got = pkern._bwd_plain(*args[:6], p_pb, p_qb, *_torch(g_full, g_fac))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)
