"""The PyTorch port's posteriors and ``posterior_decode`` against the JAX
package's.

Mirrors ``tests/test_posteriors.py``: the gradient identities, the soft
alignments, the temperature knob and the decode, on the same inputs (made
with numpy from a seed) through ``torch_asg_tpu`` and
``torch_asg_tpu_torch`` at fp64.  The port's ``'pallas'`` decode runs K3
and K5's plain versions on CPU tensors.  Tolerances: 1e-10 for posteriors
(fp64, the same recursions), paths bit-identical, scores within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu_torch.ops import posteriors as post_mod

POST_TOL = dict(rtol=1e-10, atol=1e-12)


def _case(seed=20260816, t_total=12, num_batches=3, s_total=4, num_labels=6):
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    li = np.array([12, 8, 10], np.int32)
    lo = np.array([4, 2, 3], np.int32)
    return trans, inputs, targets, li, lo


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _valid(li, t_total=12):
    return np.arange(t_total)[:, None] < np.asarray(li)[None, :]


def test_fcc_posteriors_are_score_gradients():
    trans, inputs, _, li, _ = _case()
    post = pt.fcc_posteriors(*_torch(trans, inputs, li)).numpy()
    x = torch.tensor(inputs, requires_grad=True)
    (grad,) = torch.autograd.grad(pt.fcc_score(torch.from_numpy(trans), x,
                                               torch.from_numpy(li)).sum(), x)
    np.testing.assert_allclose(post, grad.numpy(), **POST_TOL)
    np.testing.assert_allclose(post, np.asarray(jx.fcc_posteriors(*_jax(trans, inputs, li))),
                               **POST_TOL)
    sums = post.sum(axis=2)
    np.testing.assert_allclose(sums[_valid(li)], 1.0, rtol=1e-9)
    assert (sums[~_valid(li)] == 0).all()


def test_fac_posteriors_are_soft_alignments():
    trans, inputs, targets, li, lo = _case()
    post = pt.fac_posteriors(*_torch(trans, inputs, targets, li, lo)).numpy()
    want = jx.fac_posteriors(*_jax(trans, inputs, targets, li, lo))
    np.testing.assert_allclose(post, np.asarray(want), **POST_TOL)
    sums = post.sum(axis=2)
    np.testing.assert_allclose(sums[_valid(li)], 1.0, rtol=1e-9)
    assert (sums[~_valid(li)] == 0).all()
    # slot s is unreachable before frame s
    for s in range(4):
        assert (post[:s, :, s] == 0).all()


def test_fac_posteriors_are_aligned_score_gradients():
    """The aligned posterior is the aligned-domain gradient of fac_score:
    scattered back to the labels it is d fac_score / d inputs."""
    trans, inputs, targets, li, lo = _case()
    post = pt.fac_posteriors(*_torch(trans, inputs, targets, li, lo))
    x = torch.tensor(inputs, requires_grad=True)
    (grad,) = torch.autograd.grad(
        pt.fac_score(torch.from_numpy(trans), x, *_torch(targets, li, lo)).sum(), x)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(targets).long(), 6).double()
    np.testing.assert_allclose(torch.einsum("tbs,bsn->tbn", post, onehot).numpy(),
                               grad.numpy(), **POST_TOL)


def test_fac_posteriors_peak_matches_viterbi():
    """In a sharply peaked lattice the soft alignment's argmax follows the
    Viterbi alignment."""
    trans, inputs, targets, li, lo = _case()
    sharp = inputs * 20.0
    args = _torch(trans, sharp, targets, li, lo)
    post = pt.fac_posteriors(*args).numpy()
    pos = pt.viterbi_align(*args).positions.numpy()
    agree = total = 0
    for b in range(3):
        for t in range(li[b]):
            total += 1
            agree += int(post[t, b].argmax() == pos[t, b])
    assert agree / total > 0.8


def test_posteriors_differentiate_nan_free_on_ragged():
    """Gradients THROUGH the posteriors (a distillation loss) are NaN-free
    on ragged batches."""
    rng = np.random.default_rng(3)
    T, B, N, S = 8, 3, 5, 3
    trans = torch.from_numpy(rng.normal(size=(N, N)) * 0.5)
    targets = torch.from_numpy(rng.integers(0, N, size=(B, S)))
    li, lo = torch.tensor([8, 5, 2]), torch.tensor([3, 2, 1])
    teacher = torch.softmax(torch.from_numpy(rng.normal(size=(T, B, N))), dim=2)
    x = torch.tensor(rng.normal(size=(T, B, N)), requires_grad=True)
    (g,) = torch.autograd.grad(((pt.fcc_posteriors(trans, x, li) - teacher) ** 2).sum(), x)
    assert torch.isfinite(g).all()
    (g2,) = torch.autograd.grad((pt.fac_posteriors(trans, x, targets, li, lo) ** 2).sum(), x)
    assert torch.isfinite(g2).all()


def test_fcc_posteriors_large_vocab_matmul_parity(monkeypatch):
    """Above the width threshold the matmul scans take over; both forms
    agree in fp64."""
    rng = np.random.default_rng(4)
    inputs, trans = rng.normal(size=(7, 2, 9)), rng.normal(size=(9, 9)) * 0.5
    li = np.array([7, 4], np.int32)
    ref = pt.fcc_posteriors(*_torch(trans, inputs, li))
    monkeypatch.setattr(post_mod, "_MM_MIN_LABELS", 4)
    got = pt.fcc_posteriors(*_torch(trans, inputs, li))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-9, atol=1e-12)
    # posterior_decode's 'auto' then takes the scan tier, in its matmul form
    calls = []
    monkeypatch.setattr(post_mod, "_pallas_posteriors",
                        lambda *a: calls.append(a) or pytest.fail("pallas tier ran"))
    dec = pt.posterior_decode(*_torch(trans, inputs, li))
    assert not calls
    np.testing.assert_array_equal(dec.paths.numpy()[:4], ref.numpy().argmax(axis=2)[:4])


def test_posteriors_temperature_equals_scaled_inputs():
    trans, inputs, targets, li, lo = _case()
    tau = 2.5
    soft = pt.fcc_posteriors(*_torch(trans, inputs, li), temperature=tau)
    manual = pt.fcc_posteriors(*_torch(trans / tau, inputs / tau, li))
    np.testing.assert_allclose(soft.numpy(), manual.numpy(), rtol=1e-12)
    want = jx.fcc_posteriors(*_jax(trans, inputs, li), temperature=tau)
    np.testing.assert_allclose(soft.numpy(), np.asarray(want), **POST_TOL)
    soft_a = pt.fac_posteriors(*_torch(trans, inputs, targets, li, lo), temperature=tau)
    manual_a = pt.fac_posteriors(*_torch(trans / tau, inputs / tau, targets, li, lo))
    np.testing.assert_allclose(soft_a.numpy(), manual_a.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(
        pt.fcc_posteriors(*_torch(trans, inputs, li), temperature=1.0).numpy(),
        pt.fcc_posteriors(*_torch(trans, inputs, li)).numpy())


def test_posteriors_temperature_zero_limit_is_viterbi_occupancy():
    """tau -> 0 sharpens the marginals to the one-hot occupancy of the best
    path (FCC) and of the best monotone alignment (FAC)."""
    trans, inputs, targets, li, lo = _case()
    # adjacent-distinct targets: repeated labels make alignments tie exactly
    targets = (np.cumsum(targets % 5 + 1, axis=1) % 6).astype(np.int32)
    tau = 1e-3
    valid = _valid(li)
    post = pt.fcc_posteriors(*_torch(trans, inputs, li), temperature=tau).numpy()
    path = pt.viterbi_decode(*_torch(trans, inputs, li)).paths.numpy()
    onehot = np.zeros_like(post)
    for b in range(3):
        for t in range(12):
            if valid[t, b]:
                onehot[t, b, path[t, b]] = 1.0
    np.testing.assert_allclose(post, onehot, atol=1e-6)

    args = _torch(trans, inputs, targets, li, lo)
    post_a = pt.fac_posteriors(*args, temperature=tau).numpy()
    pos = pt.viterbi_align(*args).positions.numpy()
    onehot_a = np.zeros_like(post_a)
    for b in range(3):
        for t in range(12):
            if valid[t, b] and pos[t, b] >= 0:
                onehot_a[t, b, pos[t, b]] = 1.0
    np.testing.assert_allclose(post_a, onehot_a, atol=1e-6)


def test_posteriors_temperature_validation():
    trans, inputs, targets, li, lo = _torch(*_case())
    with pytest.raises(ValueError, match="temperature"):
        pt.fcc_posteriors(trans, inputs, li, temperature=0.0)
    with pytest.raises(ValueError, match="temperature"):
        pt.fac_posteriors(trans, inputs, targets, li, lo, temperature=-1.0)


def test_posterior_decode_is_argmax_of_posteriors():
    trans, inputs, _, li, _ = _case()
    res = pt.posterior_decode(*_torch(trans, inputs, li), impl="scan")
    post = pt.fcc_posteriors(*_torch(trans, inputs, li)).numpy()
    valid = _valid(li)
    got = res.paths.numpy()
    assert res.paths.dtype == torch.int32
    np.testing.assert_array_equal(got[valid], post.argmax(axis=2)[valid])
    assert (got[~valid] == -1).all()
    np.testing.assert_allclose(res.scores.numpy(),
                               np.where(valid, post.max(axis=2), 0.0).sum(axis=0),
                               rtol=1e-10)
    assert (res.scores.numpy() <= li + 1e-9).all() and (res.scores.numpy() > 0).all()


def _tie_case():
    """Integer emissions with exactly tied frames (constant across labels,
    zero transitions), so every label ties there; the decode must take the
    lowest."""
    trans, inputs, _, li, _ = _case(seed=5)
    inputs = np.round(inputs * 2)
    inputs[[0, 3, 7]] = 1.0
    inputs[5, 1] = inputs[5, 1, 2]  # a tie on one element's frame
    return np.zeros_like(trans), inputs, li


@pytest.mark.parametrize("which", ["random", "ties"])
def test_posterior_decode_pallas_matches_scan_and_jax(which):
    """The kernel-gradient tier (posteriors = d fcc_score_pallas / d inputs)
    decodes exactly as the scan tier and as the JAX package's tiers: paths
    bit-identical, ties to the lowest label, scores within 1e-9."""
    if which == "random":
        trans, inputs, _, li, _ = _case()
    else:
        trans, inputs, li = _tie_case()
    got = {impl: pt.posterior_decode(*_torch(trans, inputs, li), impl=impl)
           for impl in ("pallas", "scan", "auto")}
    want = {impl: jx.posterior_decode(*_jax(trans, inputs, li), impl=impl)
            for impl in ("pallas", "scan")}
    ref = np.asarray(want["scan"].paths)
    for res in (*got.values(), want["pallas"]):
        np.testing.assert_array_equal(np.asarray(res.paths), ref)
        np.testing.assert_allclose(np.asarray(res.scores), np.asarray(want["scan"].scores),
                                   rtol=1e-9)
    if which == "ties":
        assert (ref[[0, 3, 7]][_valid(li)[[0, 3, 7]]] == 0).all()


def test_posterior_decode_tau_to_zero_recovers_viterbi():
    trans, inputs, _, li, _ = _case()
    vit = pt.viterbi_decode(*_torch(trans, inputs, li))
    for impl in ("scan", "pallas"):
        mbr = pt.posterior_decode(*_torch(trans, inputs, li), temperature=0.05, impl=impl)
        np.testing.assert_array_equal(mbr.paths.numpy(), vit.paths.numpy())
        np.testing.assert_allclose(mbr.scores.numpy(), li.astype(np.float64), rtol=0.05)
        assert (mbr.scores.numpy() <= li + 1e-9).all()


def test_posterior_decode_validation():
    trans, inputs, _, li, _ = _torch(*_case())
    with pytest.raises(ValueError, match="impl"):
        pt.posterior_decode(trans, inputs, li, impl="nope")
    with pytest.raises(ValueError, match="temperature"):
        pt.posterior_decode(trans, inputs, li, temperature=0.0)
    with pytest.raises(ValueError, match="validate"):
        pt.posterior_decode(trans, inputs, li, validate="yes")
    wide = torch.zeros((513, 513), dtype=torch.float64)
    with pytest.raises(ValueError, match="512"):
        pt.posterior_decode(wide, torch.zeros((3, 1, 513), dtype=torch.float64),
                            impl="pallas")


def test_posterior_decode_spread_guard(monkeypatch):
    """The eager guard: 'auto' reroutes a >60-nat spread to the scan tier,
    an explicit 'pallas' raises, validate='reroute' reroutes, and
    validate=False runs the kernel tier unguarded; a healthy transition
    runs the kernel tier."""
    trans, inputs, _, li, _ = _case()
    inputs32 = torch.from_numpy(inputs.astype(np.float32))
    li_t = torch.from_numpy(li)
    wide = torch.from_numpy(trans.astype(np.float32))
    wide[0, 0] = 150.0
    ran = []
    real = post_mod._pallas_posteriors
    monkeypatch.setattr(post_mod, "_pallas_posteriors",
                        lambda *a: ran.append(1) or real(*a))

    want = pt.posterior_decode(wide, inputs32, li_t, impl="scan")
    got = pt.posterior_decode(wide, inputs32, li_t)
    assert not ran
    np.testing.assert_array_equal(got.paths.numpy(), want.paths.numpy())
    assert torch.isfinite(got.scores).all()
    with pytest.raises(ValueError, match="spread"):
        pt.posterior_decode(wide, inputs32, li_t, impl="pallas")
    got = pt.posterior_decode(wide, inputs32, li_t, impl="pallas", validate="reroute")
    assert not ran
    np.testing.assert_array_equal(got.paths.numpy(), want.paths.numpy())
    np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(), rtol=1e-6)
    res = pt.posterior_decode(wide, inputs32, li_t, impl="pallas", validate=False)
    assert ran and res.paths.shape == inputs32.shape[:2]
    ok = torch.from_numpy(trans.astype(np.float32))
    ran.clear()
    got = pt.posterior_decode(ok, inputs32, li_t)
    assert ran
    np.testing.assert_array_equal(
        got.paths.numpy(), pt.posterior_decode(ok, inputs32, li_t, impl="scan").paths.numpy())
    # the JAX package's eager contract is the same
    with pytest.raises(ValueError, match="spread"):
        jx.posterior_decode(jnp.asarray(wide.numpy()), jnp.asarray(inputs32.numpy()),
                            jnp.asarray(li), impl="pallas")


def test_posterior_decode_pallas_runs_k3_and_k5(monkeypatch):
    """The decode's kernel tier is one K3 (alpha and beta) and one K5 (the
    backward) a call, and never K4."""
    from torch_asg_tpu_torch.ops.kernels import fcc_kernels as pfcc

    calls = {"fcc_fwd": 0, "fcc_beta": 0, "fcc_bwd": 0}
    monkeypatch.setattr(pfcc, "use_kernel", lambda *tensors: True)
    for stem in calls:
        def spy(*args, stem=stem, plain=getattr(pfcc, f"{stem}_plain")):
            calls[stem] += 1
            return plain(*args)

        monkeypatch.setattr(pfcc, f"{stem}_pallas", spy)
    trans, inputs, _, li, _ = _torch(*_case())
    with torch.no_grad():
        res = pt.posterior_decode(trans, inputs, li)
    assert calls == {"fcc_fwd": 1, "fcc_beta": 0, "fcc_bwd": 1}
    np.testing.assert_array_equal(
        res.paths.numpy(), pt.posterior_decode(trans, inputs, li, impl="scan").paths.numpy())


def test_jax_posterior_decode_is_what_the_port_mirrors():
    """The JAX package's 'pallas' decode is the gradient of its kernel
    score, the identity the port's tier relies on."""
    trans, inputs, _, li, _ = _case()
    from torch_asg_tpu.ops.pallas import fcc_score_pallas

    grad = jax.grad(lambda i: fcc_score_pallas(jnp.asarray(trans), i, jnp.asarray(li)).sum())(
        jnp.asarray(inputs))
    post = pt.fcc_posteriors(*_torch(trans, inputs, li)).numpy()
    np.testing.assert_allclose(post, np.asarray(grad), **POST_TOL)
