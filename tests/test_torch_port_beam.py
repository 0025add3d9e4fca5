"""The PyTorch port's beam decoders against the JAX package.

``beam_decode`` and ``beam_nbest`` run on CPU tensors here.  Paths must be
bit-identical to the JAX package's, ties (integer emissions) and -inf
transitions included; scores agree to rtol 1e-12 (fp64).  The properties
the JAX package's tests pin (exactness at a full beam, monotonicity in the
beam size, paths that rescore to their scores, brute force) hold for the
port on their own.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops import viterbi as jvit

T, B, N = 9, 3, 6
LENGTHS = np.array([T, 1, 6], np.int32)  # L_in = T, 1 and between


def _case(seed, integer=False, neg_inf=False, num_labels=N):
    rng = np.random.default_rng(seed)
    shape = (T, len(LENGTHS), num_labels)
    if integer:
        # small integers make exact ties common at every step
        inputs = rng.integers(-2, 3, size=shape).astype(np.float64)
        trans = rng.integers(-1, 2, size=(num_labels, num_labels)).astype(np.float64)
    else:
        inputs = rng.normal(size=shape)
        trans = rng.normal(size=(num_labels, num_labels))
    if neg_inf:
        trans[rng.random(size=trans.shape) < 0.4] = -np.inf
        np.fill_diagonal(trans, 0.0)  # self-loops keep every label reachable
    return trans, inputs, LENGTHS


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _check(want, got):
    assert got.paths.dtype == torch.int32
    np.testing.assert_array_equal(got.paths.numpy(), np.asarray(want.paths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-12)


CASES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("integer,neg_inf", CASES)
@pytest.mark.parametrize("beam_size", [1, 3, N, 4 * N])
def test_beam_decode_matches_jax(integer, neg_inf, beam_size):
    case = _case(1, integer, neg_inf)
    want = jx.beam_decode(*_jax(*case), beam_size=beam_size)
    got = pt.beam_decode(*_torch(*case), beam_size=beam_size)
    _check(want, got)
    for b, length in enumerate(LENGTHS):
        assert (got.paths[length:, b] == -1).all()


@pytest.mark.parametrize("integer,neg_inf", CASES)
@pytest.mark.parametrize("n,beam_size", [(1, 1), (2, 3), (4, N)])
def test_beam_nbest_matches_jax(integer, neg_inf, n, beam_size):
    trans, inputs, li = _case(2, integer, neg_inf)
    want = jx.beam_nbest(*_jax(trans, inputs), n, jnp.asarray(li), beam_size=beam_size)
    got = pt.beam_nbest(*_torch(trans, inputs), n, torch.from_numpy(li), beam_size=beam_size)
    _check(want, got)


def test_beam_decode_wide_vocab(monkeypatch):
    """At 64 labels against the JAX package's sort-based and iterative
    top-k (its switch forced down to 8)."""
    rng = np.random.default_rng(3)
    inputs, trans = rng.normal(size=(4, 2, 64)), rng.normal(size=(64, 64)) * 0.2
    got = pt.beam_decode(*_torch(trans, inputs), beam_size=3)
    _check(jx.beam_decode(*_jax(trans, inputs), beam_size=3), got)
    monkeypatch.setattr(jvit, "_TOPK_SORT_MAX_WIDTH", 8)
    _check(jx.beam_decode(*_jax(trans, inputs), beam_size=3), got)


@pytest.mark.parametrize("neg_inf", [False, True])
def test_beam_decode_full_beam_is_exact(neg_inf):
    """beam_size >= N keeps every label: the exact decoder's scores, and on
    generic inputs its paths, ragged lengths included."""
    case = _case(4, neg_inf=neg_inf)
    want = pt.viterbi_decode(*_torch(*case), impl="xla")
    for beam_size in (N, 4 * N):
        got = pt.beam_decode(*_torch(*case), beam_size=beam_size)
        np.testing.assert_array_equal(got.scores.numpy(), want.scores.numpy())
        np.testing.assert_array_equal(got.paths.numpy(), want.paths.numpy())
    narrow = pt.beam_decode(*_torch(*case), beam_size=2)
    assert torch.isfinite(narrow.scores).all()


def test_beam_decode_scores_monotone_in_beam():
    rng = np.random.default_rng(5)
    trans, inputs = _torch(rng.normal(size=(10, 10)), rng.normal(size=(12, 4, 10)))
    exact = pt.viterbi_decode(trans, inputs, impl="xla").scores.numpy()
    prev = None
    for k in (1, 2, 4, 10):
        s = pt.beam_decode(trans, inputs, beam_size=k).scores.numpy()
        assert (s <= exact + 1e-9).all()
        if prev is not None:
            assert (s >= prev - 1e-9).all()
        prev = s
    np.testing.assert_allclose(prev, exact, rtol=1e-12)


def _rescore(trans, inputs, path, b):
    return inputs[0, b, path[0]] + sum(trans[path[t], path[t - 1]] + inputs[t, b, path[t]]
                                       for t in range(1, len(path)))


def test_beam_paths_rescore_to_scores():
    """Every returned path, beam_decode's and each rank of beam_nbest's,
    rescored on the lattice gives its score; beam_nbest's final labels are
    distinct, its scores descend and its rank 0 is beam_decode."""
    trans, inputs, li = _case(6)
    n = 4
    for beam_size in (3, 4, N):
        bd = pt.beam_decode(*_torch(trans, inputs, li), beam_size=beam_size)
        nb = pt.beam_nbest(*_torch(trans, inputs), min(n, beam_size), torch.from_numpy(li),
                           beam_size=beam_size)
        np.testing.assert_array_equal(nb.scores[:, 0].numpy(), bd.scores.numpy())
        np.testing.assert_array_equal(nb.paths[:, :, 0].numpy(), bd.paths.numpy())
        assert (np.diff(nb.scores.numpy(), axis=1) <= 0).all()
        for b, length in enumerate(li):
            p = bd.paths[:length, b].numpy()
            np.testing.assert_allclose(_rescore(trans, inputs, p, b), bd.scores[b].item(),
                                       rtol=1e-9)
            if length == 1:
                continue
            finals = nb.paths[length - 1, b].numpy()
            assert len(set(finals.tolist())) == finals.shape[0]
            for r in range(finals.shape[0]):
                p = nb.paths[:length, b, r].numpy()
                np.testing.assert_allclose(_rescore(trans, inputs, p, b),
                                           nb.scores[b, r].item(), rtol=1e-9)


def test_beam_nbest_full_beam_brute_force():
    """beam_size >= N: for each of the n best final labels, the best path
    ending there."""
    rng = np.random.default_rng(7)
    inputs, trans = rng.normal(size=(5, 2, 4)), rng.normal(size=(4, 4))
    lengths = [5, 3]
    res = pt.beam_nbest(*_torch(trans, inputs), 3, torch.tensor(lengths, dtype=torch.int32),
                        beam_size=4)
    for b, length in enumerate(lengths):
        best = {}
        for path in itertools.product(range(4), repeat=length):
            s = _rescore(trans, inputs, path, b)
            if path[-1] not in best or s > best[path[-1]][0]:
                best[path[-1]] = (s, list(path))
        ranked = sorted(best.values(), key=lambda sp: -sp[0])[:3]
        np.testing.assert_allclose(res.scores[b].numpy(), [s for s, _ in ranked], rtol=1e-9)
        for r, (_, path) in enumerate(ranked):
            col = res.paths[:, b, r].numpy()
            assert col[:length].tolist() == path
            assert (col[length:] == -1).all()


def test_beam_validation():
    trans, inputs = torch.zeros(5, 5), torch.zeros(4, 2, 5)
    with pytest.raises(ValueError, match="beam_size"):
        pt.beam_decode(trans, inputs, beam_size=0)
    with pytest.raises(ValueError, match="beam_size"):
        pt.beam_nbest(trans, inputs, 5, beam_size=4)
    with pytest.raises(ValueError, match="num_labels"):
        pt.beam_nbest(trans, inputs, 6, beam_size=8)
    with pytest.raises(ValueError, match="n must be"):
        pt.beam_nbest(trans, inputs, 0)
