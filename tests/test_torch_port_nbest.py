"""The PyTorch port's exact n-best decoder and its top-k against the JAX package.

``viterbi_nbest`` and ``_topk`` run on CPU tensors here.  Paths and indices
must be bit-identical to the JAX package's, ties (integer emissions) and -inf
included; scores agree to rtol 1e-12 (fp64).  ``lax.top_k`` returns equal
values in ascending index order, and ``_topk`` must do the same at every
width, past the JAX package's 4096-wide switch to its iterative form too.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops import viterbi as jvit
from torch_asg_tpu_torch.ops import viterbi as pvit

T, B, N = 9, 3, 5
LENGTHS = np.array([T, 1, 6], np.int32)  # L_in = T, 1 and between


def _case(seed, integer=False, neg_inf=False, t_total=T, num_labels=N):
    rng = np.random.default_rng(seed)
    shape = (t_total, len(LENGTHS), num_labels)
    if integer:
        # small integers make exact ties common at every step
        inputs = rng.integers(-2, 3, size=shape).astype(np.float64)
        trans = rng.integers(-1, 2, size=(num_labels, num_labels)).astype(np.float64)
    else:
        inputs = rng.normal(size=shape)
        trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    if neg_inf:
        trans[rng.random(size=trans.shape) < 0.4] = -np.inf
        np.fill_diagonal(trans, 0.0)  # self-loops keep every label reachable
    return trans, inputs, np.minimum(LENGTHS, t_total)


def _both(trans, inputs, k, li):
    want = jx.viterbi_nbest(jnp.asarray(trans), jnp.asarray(inputs), k, jnp.asarray(li))
    got = pt.viterbi_nbest(torch.from_numpy(trans), torch.from_numpy(inputs), k,
                           torch.from_numpy(li))
    return want, got


def _check(want, got):
    assert got.paths.dtype == torch.int32
    np.testing.assert_array_equal(got.paths.numpy(), np.asarray(want.paths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-12)


@pytest.mark.parametrize("integer,neg_inf", [(False, False), (True, False), (False, True),
                                             (True, True)])
@pytest.mark.parametrize("k", [1, 4])
def test_nbest_matches_jax(integer, neg_inf, k):
    trans, inputs, li = _case(1, integer, neg_inf)
    want, got = _both(trans, inputs, k, li)
    _check(want, got)
    for b, length in enumerate(li):
        assert (got.paths[length:, b] == -1).all()


def test_nbest_k_past_labels_at_one_frame():
    """k > N at T = 1: the tail ranks score -inf, and their labels are the
    JAX package's (the lowest labels not taken, in order)."""
    trans, inputs, _ = _case(3, t_total=1, num_labels=3)
    want, got = _both(trans, inputs, 5, np.ones(len(LENGTHS), np.int32))
    _check(want, got)
    assert np.isneginf(got.scores.numpy()[:, 3:]).all()


def test_nbest_chunked_matches(monkeypatch):
    """The destination-chunked step (forced by the threshold; the last
    chunk is short) gives the unchunked bits and the JAX package's."""
    trans, inputs, li = _case(4, num_labels=9)
    want, unchunked = _both(trans, inputs, 3, li)
    for mod in (jvit, pvit):
        monkeypatch.setattr(mod, "_CHUNK_MIN_LABELS", 4)
        monkeypatch.setattr(mod, "_CHUNK_SIZE", 4)
    want_c, got = _both(trans, inputs, 3, li)
    _check(want, got)
    _check(want_c, got)
    np.testing.assert_array_equal(got.scores.numpy(), unchunked.scores.numpy())


def _brute_force_nbest(transition, inputs, length, k):
    scored = []
    for path in itertools.product(range(inputs.shape[1]), repeat=length):
        s = inputs[0, path[0]]
        for t in range(1, length):
            s += transition[path[t], path[t - 1]] + inputs[t, path[t]]
        scored.append((s, list(path)))
    scored.sort(key=lambda x: -x[0])
    return scored[:k]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_nbest_brute_force(k):
    rng = np.random.default_rng(7)
    lengths = [4, 3]
    inputs = rng.normal(size=(4, 2, 3))
    trans = rng.normal(size=(3, 3))
    res = pt.viterbi_nbest(torch.from_numpy(trans), torch.from_numpy(inputs), k,
                           torch.tensor(lengths, dtype=torch.int32))
    for b, length in enumerate(lengths):
        for rank, (score, path) in enumerate(_brute_force_nbest(trans, inputs[:, b],
                                                                length, k)):
            np.testing.assert_allclose(res.scores[b, rank].item(), score, rtol=1e-12)
            col = res.paths[:, b, rank].numpy()
            assert col[:length].tolist() == path
            assert (col[length:] == -1).all()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_nbest_rank0_is_decode(impl):
    trans, inputs, li = _case(5)
    args = (torch.from_numpy(trans), torch.from_numpy(inputs))
    nb = pt.viterbi_nbest(*args, 4, torch.from_numpy(li))
    one = pt.viterbi_decode(*args, torch.from_numpy(li), impl=impl)
    np.testing.assert_array_equal(nb.scores[:, 0].numpy(), one.scores.numpy())
    np.testing.assert_array_equal(nb.paths[:, :, 0].numpy(), one.paths.numpy())
    scores, paths = nb.scores.numpy(), nb.paths.numpy()
    assert (np.diff(scores, axis=1) <= 0).all()
    for b in (0, 2):  # elements with more than 4 paths: all 4 distinct
        assert len({tuple(paths[:, b, r]) for r in range(4)}) == 4


def _ties(rng, shape):
    """Normal draws with manufactured exact ties, -inf rows and rows with
    fewer finite entries than k."""
    x = rng.normal(size=shape)
    x[0, 17] = x[0, 3] = 50.0  # a tie inside the top k
    x[1, :] = 1.0  # every entry ties
    x[2, 10:14] = x[2, 2]
    x[3, :] = -np.inf  # n-best's unseeded rank slots
    x[4, 2:] = -np.inf  # two finite entries
    return x


@pytest.mark.parametrize("width,k", [(200, 1), (200, 4), (200, 200), (5000, 1), (5000, 4)])
def test_topk_matches_lax(width, k):
    """``_topk`` against ``lax.top_k`` (values and indices), on both sides
    of the JAX package's 4096-wide switch, ``k == width`` included; past the
    switch also against the JAX package's iterative form."""
    x = _ties(np.random.default_rng(width + k), (5, width))
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = pvit._topk(torch.from_numpy(x), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    if width > jvit._TOPK_SORT_MAX_WIDTH:
        jax_v, jax_i = jvit._topk(jnp.asarray(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(jax_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(jax_v))


def test_topk_rejects_k_past_width():
    with pytest.raises(ValueError, match="exceeds"):
        pvit._topk(torch.zeros(2, 3), 4)
