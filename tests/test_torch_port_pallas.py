"""The PyTorch port's per-lattice tier (``impl='pallas'``: K3-K8) against
the JAX package's.

Mirrors ``tests/test_pallas.py`` case for case, with the same ``_case``
shapes and seeds: the same inputs, made with numpy, go through
``torch_asg_tpu``'s Pallas kernels (interpret mode on the CPU) and
``torch_asg_tpu_torch``'s wrappers, which CPU tensors send to each kernel's
plain version, both at fp64.  Tolerances are ``tests/test_pallas.py``'s:
rtol 1e-9 for scores, rtol 1e-8 / atol 1e-12 for gradients; each plain
version against the Pallas kernel it stands for at the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops.pallas import fac_kernels as jfac
from torch_asg_tpu.ops.pallas import fcc_kernels as jfcc
from torch_asg_tpu_torch.ops.fac import make_aligned
from torch_asg_tpu_torch.ops.kernels import fac_kernels as pfac
from torch_asg_tpu_torch.ops.kernels import fcc_kernels as pfcc

SCORE_TOL = dict(rtol=1e-9)
GRAD_TOL = dict(rtol=1e-8, atol=1e-12)


def _case(seed, T, B, S, N, ragged=True):
    r = np.random.default_rng(seed)
    inputs = r.normal(size=(T, B, N))
    trans = r.normal(size=(N, N)) * 0.5
    targets = r.integers(0, N, size=(B, S))
    if ragged:
        li = r.integers(max(S, 1), T + 1, size=(B,))
        lo = r.integers(1, S + 1, size=(B,))
    else:
        li = np.full((B,), T)
        lo = np.full((B,), S)
    return trans, inputs, targets, li, lo


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _port_grads(fn, trans, inputs):
    t = torch.tensor(trans, requires_grad=True)
    i = torch.tensor(inputs, requires_grad=True)
    gt, gi = torch.autograd.grad(fn(t, i), (t, i))
    return gt.numpy(), gi.numpy()


def _jax_grads(fn, trans, inputs):
    return [np.asarray(g) for g in jax.grad(fn, argnums=(0, 1))(*_jax(trans, inputs))]


def _assert_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_fcc_pallas_forward(ragged):
    trans, inputs, targets, li, lo = _case(0, T=9, B=3, S=3, N=5, ragged=ragged)
    want = jfcc.fcc_score_pallas(*_jax(trans, inputs, li))
    got = pfcc.fcc_score_pallas(*_torch(trans, inputs, li))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_fcc_pallas_grads(ragged):
    trans, inputs, targets, li, lo = _case(1, T=7, B=3, S=3, N=5, ragged=ragged)
    want = _jax_grads(lambda t, i: jfcc.fcc_score_pallas(t, i, jnp.asarray(li)).sum(),
                      trans, inputs)
    got = _port_grads(lambda t, i: pfcc.fcc_score_pallas(t, i, torch.from_numpy(li)).sum(),
                      trans, inputs)
    _assert_grads(got, want)


@pytest.mark.parametrize("ragged", [False, True])
def test_fac_pallas_forward(ragged):
    trans, inputs, targets, li, lo = _case(2, T=9, B=3, S=4, N=5, ragged=ragged)
    want = jfac.fac_score_pallas(*_jax(trans, inputs, targets, li, lo))
    got = pfac.fac_score_pallas(*_torch(trans, inputs, targets, li, lo))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_fac_pallas_grads(ragged):
    trans, inputs, targets, li, lo = _case(3, T=7, B=3, S=4, N=5, ragged=ragged)
    want = _jax_grads(
        lambda t, i: jfac.fac_score_pallas(t, i, *_jax(targets, li, lo)).sum(), trans, inputs)
    got = _port_grads(
        lambda t, i: pfac.fac_score_pallas(t, i, *_torch(targets, li, lo)).sum(), trans, inputs)
    _assert_grads(got, want)


def test_asg_loss_pallas_impl():
    trans, inputs, targets, li, lo = _case(4, T=8, B=2, S=3, N=6)
    want = jx.asg_loss(*_jax(trans, inputs, targets, li, lo), reduction="none",
                       impl="pallas")
    got = pt.asg_loss(*_torch(trans, inputs, targets, li, lo), reduction="none",
                      impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    # against the port's own scan tier too
    scan = pt.asg_loss(*_torch(trans, inputs, targets, li, lo), reduction="none",
                       impl="scan")
    np.testing.assert_allclose(got.numpy(), scan.numpy(), **SCORE_TOL)

    want = _jax_grads(lambda t, i: jx.asg_loss(t, i, *_jax(targets, li, lo),
                                               reduction="sum", impl="pallas"),
                      trans, inputs)
    got = _port_grads(lambda t, i: pt.asg_loss(t, i, *_torch(targets, li, lo),
                                               reduction="sum", impl="pallas"),
                      trans, inputs)
    _assert_grads(got, want)


def _finite_sum(scores):
    return torch.where(torch.isfinite(scores), scores, torch.zeros_like(scores)).sum()


def _jax_finite_sum(scores):
    return jnp.sum(jnp.where(jnp.isfinite(scores), scores, 0.0))


@pytest.mark.parametrize("lattice", ["fcc", "fac"])
def test_degenerate_lengths_match_jax(lattice):
    """L_in = 1, L_out = 1, L_out > L_in and L_in outside [1, T]: the same
    scores as the JAX kernels (-inf where there is no path) and the same
    finite gradients of the finite scores."""
    trans, inputs, targets, _, _ = _case(5, T=9, B=6, S=4, N=6)
    li = np.array([1, 9, 4, 2, 0, 10])
    lo = np.array([1, 1, 4, 4, 2, 2])
    if lattice == "fcc":
        jfn = lambda t, i: jfcc.fcc_score_pallas(t, i, jnp.asarray(li))  # noqa: E731
        pfn = lambda t, i: pfcc.fcc_score_pallas(t, i, torch.from_numpy(li))  # noqa: E731
    else:
        jfn = lambda t, i: jfac.fac_score_pallas(t, i, *_jax(targets, li, lo))  # noqa: E731
        pfn = lambda t, i: pfac.fac_score_pallas(t, i, *_torch(targets, li, lo))  # noqa: E731
    want = np.asarray(jfn(*_jax(trans, inputs)))
    got = pfn(*_torch(trans, inputs)).numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    assert np.isneginf(got[4:]).all()
    if lattice == "fac":
        assert np.isneginf(got[3])  # L_out > L_in: unalignable
    want_g = _jax_grads(lambda t, i: _jax_finite_sum(jfn(t, i)), trans, inputs)
    got_g = _port_grads(lambda t, i: _finite_sum(pfn(t, i)), trans, inputs)
    for g in got_g:
        assert np.isfinite(g).all()
    _assert_grads(got_g, want_g)
    assert (got_g[1][:, 4:] == 0).all()


def test_neg_inf_transitions_match_jax():
    """-inf transition entries (forbidden moves, the semiring zero): scores
    and gradients as the JAX kernels give them, finite and NaN-free."""
    trans, inputs, targets, li, lo = _case(6, T=11, B=3, S=4, N=6)
    trans[np.random.default_rng(6).random(trans.shape) < 0.3] = -np.inf
    want = _jax_grads(lambda t, i: jx.asg_loss(t, i, *_jax(targets, li, lo),
                                               reduction="sum", impl="pallas"),
                      trans, inputs)
    got = _port_grads(lambda t, i: pt.asg_loss(t, i, *_torch(targets, li, lo),
                                               reduction="sum", impl="pallas"),
                      trans, inputs)
    assert np.isfinite(got[1]).all()
    # -inf transition entries get a zero gradient (exp(-inf) = 0)
    assert (got[0][np.isneginf(trans)] == 0).all()
    _assert_grads(got, want)


@pytest.mark.parametrize("wide", ["labels", "targets"])
def test_width_refusal_matches_jax(wide):
    """Both packages refuse the per-lattice tier past 512 labels or target
    slots with a ValueError; 512 itself runs."""
    n, s = (513, 3) if wide == "labels" else (6, 513)
    r = np.random.default_rng(7)
    inputs, trans = r.normal(size=(s + 1, 1, n)), np.zeros((n, n))
    targets = r.integers(0, n, size=(1, s))
    with pytest.raises(ValueError, match="512"):
        jx.asg_loss(*_jax(trans, inputs, targets), impl="pallas")
    with pytest.raises(ValueError, match="512"):
        pt.asg_loss(*_torch(trans, inputs, targets), impl="pallas")
    n, s = (512, 3) if wide == "labels" else (6, 512)
    inputs, trans = r.normal(size=(s + 1, 1, n)), np.zeros((n, n))
    targets = r.integers(0, n, size=(1, s))
    got = pt.asg_loss(*_torch(trans, inputs, targets), impl="pallas", reduction="none")
    want = pt.asg_loss(*_torch(trans, inputs, targets), impl="scan", reduction="none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SCORE_TOL)


@pytest.mark.parametrize("lattice", ["fcc", "fac"])
def test_gradcheck(lattice):
    """Finite differences against the custom backward, fp64, tiny shape."""
    trans, inputs, targets, li, lo = _case(8, T=6, B=2, S=3, N=4)
    args = _torch(targets, li, lo)
    if lattice == "fcc":
        fn = lambda t, i: pfcc.fcc_score_pallas(t, i, args[1])  # noqa: E731
    else:
        fn = lambda t, i: pfac.fac_score_pallas(t, i, *args)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (torch.tensor(trans, requires_grad=True),
                                         torch.tensor(inputs, requires_grad=True)))


def test_plain_versions_match_jax_kernels():
    """K3-K8's plain versions against the Pallas kernels they stand for
    (interpret mode), output by output, on the same inputs: alpha and beta
    of both lattices, then the backward kernels on those chains."""
    trans, inputs, targets, li, lo = _case(9, T=11, B=3, S=4, N=6)
    g = np.array([1.0, 0.5, -2.0])
    inputs_p, li_col, c, e, e_t, dims = jfcc._prepare(*_jax(trans, inputs, li))
    t_total, num_batches, num_labels = inputs.shape
    alpha, beta = jfcc._run_fwd(c, li_col, e, e_t, inputs_p)
    beta_only = jfcc._run_beta(c, li_col, e, inputs_p)
    g_col = jnp.pad(jnp.asarray(g), (0, dims[3] - num_batches))[:, None]
    gi, gt = jfcc._run_bwd(c, li_col, g_col, e_t, inputs_p, alpha, beta)

    def cut(x):
        return np.asarray(x)[:t_total, :num_batches, :num_labels]

    p_e, p_c, p_x, p_li = pfcc._prepare(*_torch(trans, inputs, li))
    p_alpha, p_beta = pfcc.fcc_fwd_plain(p_e, p_c, p_x, p_li)
    np.testing.assert_allclose(p_alpha.numpy(), cut(alpha), **GRAD_TOL)
    np.testing.assert_allclose(p_beta.numpy(), cut(beta), **GRAD_TOL)
    np.testing.assert_allclose(pfcc.fcc_beta_plain(p_e, p_c, p_x, p_li).numpy(),
                               cut(beta_only), **GRAD_TOL)
    p_gi, p_gt = pfcc.fcc_bwd_plain(p_e, p_c, p_x, p_li, p_alpha, p_beta,
                                    torch.from_numpy(g))
    np.testing.assert_allclose(p_gi.numpy(), cut(gi), **GRAD_TOL)
    np.testing.assert_allclose(p_gt.numpy(), np.asarray(gt)[:num_labels, :num_labels],
                               **GRAD_TOL)

    lat, ali_p, self_t, next_t, li_c, lo_c, fdims = jfac._prepare(
        *_jax(trans, inputs, targets, li, lo))
    s_total = targets.shape[1]
    f_alpha = jfac._fac_alpha_pass(self_t, next_t, ali_p)
    f_beta = jfac._fac_beta_pass(li_c, lo_c, self_t, next_t, ali_p)
    g_col = jnp.pad(jnp.asarray(g), (0, fdims[3] - num_batches))[:, None]
    f_gi, f_gself, f_gnext = jfac._fac_bwd_pass(g_col, self_t, next_t, ali_p, f_alpha, f_beta)

    p_lat = make_aligned(*_torch(trans, inputs, targets, li, lo))
    q_alpha = pfac.fac_alpha_plain(p_lat)
    q_beta = pfac.fac_beta_plain(p_lat, *_torch(li, lo))
    np.testing.assert_allclose(q_alpha.numpy(), np.asarray(f_alpha)[:, :num_batches, :s_total],
                               **GRAD_TOL)
    np.testing.assert_allclose(q_beta.numpy(), np.asarray(f_beta)[:, :num_batches, :s_total],
                               **GRAD_TOL)
    got = pfac.fac_bwd_plain(p_lat, q_alpha, q_beta, torch.from_numpy(g))
    want = (np.asarray(f_gi)[:, :num_batches, :s_total],
            np.asarray(f_gself)[:num_batches, :s_total],
            np.asarray(f_gnext)[:num_batches, :s_total])
    for q, w in zip(got, want):
        np.testing.assert_allclose(q.numpy(), w, **GRAD_TOL)


def _counting(monkeypatch):
    """Make every tensor take the kernel route, with each of K3-K8's
    wrappers replaced by its plain version plus a launch count."""
    calls = {}
    for mod, stems in ((pfcc, ("fcc_fwd", "fcc_beta", "fcc_bwd")),
                       (pfac, ("fac_alpha", "fac_beta", "fac_bwd"))):
        monkeypatch.setattr(mod, "use_kernel", lambda *tensors: True)
        for stem in stems:
            calls[stem] = 0

            def spy(*args, stem=stem, plain=getattr(mod, f"{stem}_plain")):
                calls[stem] += 1
                return plain(*args)

            monkeypatch.setattr(mod, f"{stem}_pallas", spy)
    return calls


def test_launch_counts(monkeypatch):
    """A score-only call runs K4 and K7 alone; a differentiated call runs
    K3, K6 and K7 forward and K5 and K8 backward, and never K4."""
    calls = _counting(monkeypatch)
    trans, inputs, targets, li, lo = _torch(*_case(10, T=9, B=2, S=3, N=5))
    with torch.no_grad():
        pt.asg_scores(trans, inputs, targets, li, lo, impl="pallas")
    assert calls == {"fcc_fwd": 0, "fcc_beta": 1, "fcc_bwd": 0,
                     "fac_alpha": 0, "fac_beta": 1, "fac_bwd": 0}
    inputs.requires_grad_(True)
    loss = pt.asg_loss(trans, inputs, targets, li, lo, impl="pallas")
    assert calls == {"fcc_fwd": 1, "fcc_beta": 1, "fcc_bwd": 0,
                     "fac_alpha": 1, "fac_beta": 2, "fac_bwd": 0}
    loss.backward()
    assert calls == {"fcc_fwd": 1, "fcc_beta": 1, "fcc_bwd": 1,
                     "fac_alpha": 1, "fac_beta": 2, "fac_bwd": 1}
    assert torch.isfinite(inputs.grad).all()
