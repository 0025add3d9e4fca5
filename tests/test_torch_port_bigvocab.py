"""The PyTorch port's matmul tier against the JAX package's.

The dual-stream kernel K9's plain version (which CPU tensors run) against the
Pallas kernel it replaces (interpret mode) and against the two matmul-tier
scans; ``fcc_score_matmul`` with either formulation of the chains against
JAX's; ``asg_loss(impl='auto')`` past the fused tier's 512-label width; the
dual-stream election.  All at fp64, inputs made with numpy from a seed.
Tolerances: ``tests/test_bigvocab.py``'s (1e-9 for the streams, rtol 1e-8 /
atol 1e-10 for the gradients); ``tests/test_torch_port_grads.py``'s for the
criterion (values 1e-10, gradients rtol 1e-9 / atol 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops import fcc as jfcc
from torch_asg_tpu.ops.pallas.bigvocab_kernels import fcc_dual_streams as jax_dual
from torch_asg_tpu.utils.lengths import mask_emissions as jax_mask
from torch_asg_tpu_torch.ops import fcc as pfcc
from torch_asg_tpu_torch.ops.kernels import bigvocab_kernels as pbk
from torch_asg_tpu_torch.ops.semiring import chain_precision, strict_chain_precision
from torch_asg_tpu_torch.utils.lengths import mask_emissions

STREAM_TOL = dict(rtol=1e-9, atol=1e-9)
GRAD_TOL = dict(rtol=1e-8, atol=1e-10)
SHAPES = [(6, 3, 130), (9, 2, 260), (2, 1, 128), (5, 9, 40)]


def _case(seed, t_total, num_batches, num_labels, lengths=None):
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels))
    if lengths is None:
        lengths = rng.integers(1, t_total + 1, size=num_batches)
        lengths[0] = t_total  # the L_in == T beta seed
    return trans, inputs, np.asarray(lengths, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_streams(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _inf_case(seed):
    trans, inputs, li = _case(seed, 7, 2, 150)
    trans[:, 3] = -np.inf
    trans[5, :] = -np.inf
    return trans, inputs, li


CASES = [_case(i, *s) for i, s in enumerate(SHAPES)] + [_inf_case(9)]
CASE_IDS = [f"T{s[0]}_B{s[1]}_N{s[2]}" for s in SHAPES] + ["neg_inf_row_col"]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_dual_plain_matches_jax_kernel(case):
    """K9's plain version against the Pallas kernel (interpret mode)."""
    trans, inputs, li = case
    want = jax_dual(jnp.asarray(trans), jax_mask(*_jax(inputs, li)), jnp.asarray(li))
    t, x, lt = _torch(trans, inputs, li)
    got = pbk.fcc_dual_streams_plain(t, mask_emissions(x, lt), lt)
    _assert_streams(got, want, **STREAM_TOL)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scans_mm_match_jax(case):
    """The port's two matmul-tier scans against JAX's, and K9's plain version
    against the port's scans."""
    trans, inputs, li = case
    jt, jl = _jax(trans, li)
    jm = jax_mask(jnp.asarray(inputs), jl)
    t, x, lt = _torch(trans, inputs, li)
    xm = mask_emissions(x, lt)
    got = (pfcc._alpha_scan_mm(t, xm), pfcc._beta_scan_mm(t, xm, lt))
    _assert_streams(got, (jfcc._alpha_scan_mm(jt, jm), jfcc._beta_scan_mm(jt, jm, jl)),
                    **STREAM_TOL)
    _assert_streams(pbk.fcc_dual_streams_plain(t, xm, lt), [g.numpy() for g in got],
                    **STREAM_TOL)


def test_dual_t1_boundary():
    trans, inputs, li = _case(10, 1, 3, 140, lengths=[1, 1, 1])
    t, x, lt = _torch(trans, inputs, li)
    xm = mask_emissions(x, lt)
    want = jax_dual(*_jax(trans), jax_mask(*_jax(inputs, li)), jnp.asarray(li))
    for got in (pbk.fcc_dual_streams_plain(t, xm, lt), pbk.fcc_dual_streams(t, xm, lt)):
        _assert_streams(got, want, rtol=0, atol=0)


def _port_grads(trans, inputs, li, dual):
    t = torch.tensor(trans, requires_grad=True)
    x = torch.tensor(inputs, requires_grad=True)
    with pfcc.force_dual_streams(dual):
        out = pfcc.fcc_score_matmul(t, x, torch.from_numpy(li)).sum()
    gt, gx = torch.autograd.grad(out, (t, x))
    return out.detach().numpy(), gt.numpy(), gx.numpy()


def _jax_grads(trans, inputs, li, dual):
    def loss(tr, ins):
        with jfcc.force_dual_streams(dual):
            return jnp.sum(jfcc.fcc_score_matmul(tr, ins, jnp.asarray(li)))

    out, (gt, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(*_jax(trans, inputs))
    return np.asarray(out), np.asarray(gt), np.asarray(gx)


@pytest.mark.parametrize("dual", [True, False])
def test_fcc_score_matmul_grads_match_jax(dual):
    """Value, dT and dI through K9's plain version (True) or the two scans
    (False), on both sides, ragged lengths."""
    trans, inputs, li = _case(11, 8, 3, 135)
    got = _port_grads(trans, inputs, li, dual)
    want = _jax_grads(trans, inputs, li, dual)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)
    other = _port_grads(trans, inputs, li, not dual)
    for g, o in zip(got, other):
        np.testing.assert_allclose(g, o, **GRAD_TOL)


def _asg_case(seed, t_total, num_batches, s_total, num_labels):
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    li = rng.integers(max(s_total, t_total // 2), t_total + 1, size=num_batches)
    li[0] = t_total
    lo = rng.integers(1, s_total + 1, size=num_batches)
    return trans, inputs, targets, li.astype(np.int32), lo.astype(np.int32)


@pytest.mark.parametrize("impl,shape", [("auto", (7, 3, 4, 520)), ("matmul", (9, 3, 5, 40))],
                         ids=["auto_N520", "matmul_N40"])
def test_asg_loss_matmul_tier_matches_jax(impl, shape):
    """Past 512 labels 'auto' runs the matmul tier; value and gradients
    against JAX's ``asg_loss`` with the same impl, on a ragged batch."""
    trans, inputs, targets, li, lo = _asg_case(12, *shape)
    t = torch.tensor(trans, requires_grad=True)
    x = torch.tensor(inputs, requires_grad=True)
    loss = pt.asg_loss(t, x, *_torch(targets, li, lo), reduction="sum", impl=impl)
    gt, gx = torch.autograd.grad(loss, (t, x))
    want, (wt, wx) = jax.jit(jax.value_and_grad(
        lambda tr, ins: jx.asg_loss(tr, ins, *_jax(targets, li, lo), reduction="sum",
                                    impl=impl), argnums=(0, 1)))(*_jax(trans, inputs))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-9, atol=1e-12)
    # the 'scan' tier's log-domain chains agree
    scan = pt.asg_loss(*_torch(trans, inputs, targets, li, lo), reduction="sum", impl="scan")
    np.testing.assert_allclose(loss.detach().numpy(), scan.numpy(), rtol=1e-10)


def _counting(monkeypatch):
    """Every tensor takes K9's kernel route, with the launch replaced by the
    plain version plus a count."""
    monkeypatch.setattr(pbk, "use_kernel", lambda *tensors: True)
    calls = []

    def spy(*args):
        calls.append(1)
        return pbk.fcc_dual_streams_plain(*args)

    monkeypatch.setattr(pbk, "_dual_kernel", spy)
    return calls


def test_forward_only_call_launches_no_dual_kernel(monkeypatch):
    """With the election forced, a differentiated call launches K9 once and
    a call autograd will not differentiate never does."""
    calls = _counting(monkeypatch)
    trans, inputs, targets, li, lo = _torch(*_asg_case(13, 6, 2, 3, 520))
    x = inputs.clone().requires_grad_(True)
    with pfcc.force_dual_streams(True):
        with torch.no_grad():
            pt.asg_loss(trans, x, targets, li, lo)
        pt.asg_scores(trans, inputs, targets, li, lo)
        assert calls == []
        loss = pt.asg_loss(trans, x, targets, li, lo)
        assert len(calls) == 1
        loss.backward()
    assert len(calls) == 1 and torch.isfinite(x.grad).all()


def test_resolve_dual_election():
    cpu = torch.zeros((5, 2, 3))
    assert pfcc._resolve_dual(cpu) is False
    with pfcc.force_dual_streams(True):
        assert pfcc._resolve_dual(cpu) is True
        assert pfcc._resolve_dual(torch.zeros((1, 2, 3))) is False  # T = 1
    with pfcc.force_dual_streams(False):
        assert pfcc._resolve_dual(cpu) is False
    # a tensor on the card, without allocating one: only .is_cuda and .shape
    # are read
    class OnCard:
        is_cuda = True
        shape = (5, 2, 3)

    assert pfcc._resolve_dual(OnCard()) is True
    with strict_chain_precision():
        assert chain_precision() == "highest"
        assert pfcc._resolve_dual(OnCard()) is False
    assert chain_precision() == "default"
    with pytest.raises(ValueError, match="precision"):
        with strict_chain_precision("high"):
            pass


def test_precision_argument_keeps_the_value():
    """``precision='highest'`` selects the scans but not other arithmetic."""
    trans, inputs, targets, li, lo = _torch(*_asg_case(14, 6, 2, 3, 40))
    base = pt.asg_loss(trans, inputs, targets, li, lo, impl="matmul", reduction="none")
    for precision in ("default", "highest"):
        got = pt.asg_scores(trans, inputs, targets, li, lo, impl="matmul",
                            precision=precision)
        np.testing.assert_allclose((got[0] - got[1]).numpy(), base.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="precision"):
        pt.asg_loss(trans, inputs, targets, li, lo, precision="bf16")


def test_lse_mm_dead_row_gradient_is_finite():
    """A row of x that is all -inf stays -inf with a finite gradient, as
    JAX's double-where gives it."""
    rng = np.random.default_rng(15)
    x = rng.normal(size=(3, 6))
    x[1] = -np.inf
    mat = np.exp(rng.normal(size=(6, 6)))

    def port(xx):
        out = pfcc._lse_mm(xx, torch.from_numpy(mat), torch.tensor(0.3, dtype=torch.float64))
        return out, torch.where(torch.isfinite(out), out, 0.0).sum()

    xt = torch.tensor(x, requires_grad=True)
    out, total = port(xt)
    (g,) = torch.autograd.grad(total, xt)
    assert torch.isinf(out[1]).all() and torch.isfinite(g).all()

    def jax_total(xx):
        o = jfcc._lse_mm(xx, jnp.asarray(mat), jnp.asarray(0.3))
        return jnp.sum(jnp.where(jnp.isfinite(o), o, 0.0))

    want = jax.grad(jax_total)(jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_wide_spread_gradient_is_clamped_like_jax():
    """A > 60-nat transition spread under validate=False: the factor-form
    gradient's exponent clamps at 60, giving JAX's finite dT."""
    trans, inputs, targets, li, lo = _asg_case(16, 6, 2, 3, 40)
    trans[2, 7] = 80.0
    trans[9, 1] = -15.0
    t = torch.tensor(trans, requires_grad=True)
    x = torch.tensor(inputs, requires_grad=True)
    loss = pt.asg_loss(t, x, *_torch(targets, li, lo), reduction="sum", impl="matmul",
                       validate=False)
    gt, gx = torch.autograd.grad(loss, (t, x))
    _, (wt, wx) = jax.jit(jax.value_and_grad(
        lambda tr, ins: jx.asg_loss(tr, ins, *_jax(targets, li, lo), reduction="sum",
                                    impl="matmul", validate=False),
        argnums=(0, 1)))(*_jax(trans, inputs))
    assert np.isfinite(gt.numpy()).all()
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-9, atol=1e-12)
