"""The PyTorch port's generic WFSA scoring against the JAX package.

The tests of ``tests/test_wfsa.py`` are mirrored on CPU tensors at fp64
(the two ASG lattices as the extreme automata, brute-force enumeration,
lexicons), and each port function is held against the JAX function on the
same graph: scores and posteriors at rtol 1e-12, paths, states and the
lowest-arc-id tie rule exactly.  The fixed-order reductions (``_plan``) are
checked on their own: tables, skewed in-degrees, empty segments, and the
same bits from two runs.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops import wfsa as jw
from torch_asg_tpu.ops.fac import make_aligned as jx_make_aligned
from torch_asg_tpu_torch.ops import wfsa as pw
from torch_asg_tpu_torch.ops.fac import make_aligned

NEG_INF = float("-inf")


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, T=9, B=3, N=5, S=4):
    inputs = rng.normal(size=(T, B, N))
    trans = rng.normal(size=(N, N)) * 0.7
    targets = rng.integers(0, N, size=(B, S)).astype(np.int32)
    li = np.asarray([T, T - 2, S], np.int32)
    lo = np.asarray([S, S - 1, S - 2], np.int32)
    return inputs, trans, targets, li, lo


def _close(got, want, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_full_wfsa_matches_fcc(rng):
    inputs, trans, _, li, _ = _case(rng)
    got = pt.wfsa_score(pt.full_wfsa(_t(trans)), _t(inputs), _t(li))
    _close(got, pt.fcc_score(_t(trans), _t(inputs), _t(li)).numpy(), rtol=1e-10)
    _close(got, jx.wfsa_score(jx.full_wfsa(jnp.asarray(trans)), jnp.asarray(inputs),
                              jnp.asarray(li)))


def test_chain_wfsa_matches_fac(rng):
    inputs, trans, targets, li, lo = _case(rng)
    ref = pt.fac_score(_t(trans), _t(inputs), _t(targets), _t(li), _t(lo))
    lat = make_aligned(_t(trans), _t(inputs), _t(targets), _t(li), _t(lo))
    jlat = jx_make_aligned(jnp.asarray(trans), jnp.asarray(inputs), jnp.asarray(targets),
                           jnp.asarray(li), jnp.asarray(lo))
    for b in range(inputs.shape[1]):
        n_out = int(lo[b])
        fsa = pt.chain_wfsa(_t(targets[b, :n_out]), lat.self_trans[b, :n_out],
                            lat.next_trans[b, :n_out])
        jfsa = jx.chain_wfsa(jnp.asarray(targets[b, :n_out]), jlat.self_trans[b, :n_out],
                             jlat.next_trans[b, :n_out])
        for got, want in zip(fsa, jfsa):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = pt.wfsa_score(fsa, _t(inputs[:, b:b + 1]), _t(li[b:b + 1]))
        np.testing.assert_allclose(got.item(), ref[b].item(), rtol=1e-10)


def _tiny_grammar(rng):
    src = np.asarray([0, 0, 1, 1, 2, 2], np.int32)
    dst = np.asarray([0, 1, 1, 2, 2, 0], np.int32)
    ilab = np.asarray([0, 1, 2, 3, 1, 0], np.int32)
    w = rng.normal(size=(6,))
    start = np.asarray([0.0, NEG_INF, NEG_INF])
    final = np.asarray([NEG_INF, -0.3, 0.7])
    return src, dst, ilab, w, start, final


def test_wfsa_brute_force_small(rng):
    """A 3-state grammar automaton vs explicit path enumeration."""
    T, N = 4, 4
    inputs = rng.normal(size=(T, 1, N))
    arrays = _tiny_grammar(rng)
    fsa = pt.WFSA(*(_t(a) for a in arrays))
    got = pt.wfsa_score(fsa, _t(inputs))[0].item()
    vit = pt.wfsa_viterbi(fsa, _t(inputs))

    src, dst, ilab, w, start, final = arrays
    arcs = list(zip(src.tolist(), dst.tolist(), ilab.tolist(), w.tolist()))
    scores, best = [], (-np.inf, None)
    for path in itertools.product(range(6), repeat=T):
        state, tot, ok = 0, 0.0, True
        for t, a in enumerate(path):
            s, d, lab, wt = arcs[a]
            if s != state:
                ok = False
                break
            tot += wt + inputs[t, 0, lab]
            state = d
        if not ok or not np.isfinite(final[state]):
            continue
        tot += final[state]
        scores.append(tot)
        if tot > best[0]:
            best = (tot, path)
    ref = float(jax.scipy.special.logsumexp(jnp.asarray(scores)))
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    np.testing.assert_allclose(vit.scores[0].item(), best[0], rtol=1e-9)
    np.testing.assert_array_equal(vit.labels[:, 0].numpy(), [arcs[a][2] for a in best[1]])
    jfsa = jx.WFSA(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(got, float(jx.wfsa_score(jfsa, jnp.asarray(inputs))[0]),
                               rtol=1e-12)


def test_wfsa_viterbi_matches_decoders(rng):
    inputs, trans, targets, li, lo = _case(rng)
    ref = pt.viterbi_decode(_t(trans), _t(inputs), _t(li))
    got = pt.wfsa_viterbi(pt.full_wfsa(_t(trans)), _t(inputs), _t(li))
    _close(got.scores, ref.scores.numpy(), rtol=1e-10)
    assert torch.equal(got.labels, ref.paths)
    refa = pt.viterbi_align(_t(trans), _t(inputs), _t(targets), _t(li), _t(lo))
    lat = make_aligned(_t(trans), _t(inputs), _t(targets), _t(li), _t(lo))
    for b in range(inputs.shape[1]):
        n_out = int(lo[b])
        fsa = pt.chain_wfsa(_t(targets[b, :n_out]), lat.self_trans[b, :n_out],
                            lat.next_trans[b, :n_out])
        gb = pt.wfsa_viterbi(fsa, _t(inputs[:, b:b + 1]), _t(li[b:b + 1]))
        np.testing.assert_allclose(gb.scores[0].item(), refa.scores[b].item(), rtol=1e-10)
        assert torch.equal(gb.states[:, 0], refa.positions[:, b])


def test_wfsa_posteriors_sum_to_one(rng):
    inputs, trans, _, li, _ = _case(rng)
    post = pt.wfsa_posteriors(pt.full_wfsa(_t(trans)), _t(inputs), _t(li))
    sums = post.sum(dim=2).numpy()
    tmask = np.arange(inputs.shape[0])[:, None] < li[None, :]
    np.testing.assert_allclose(sums[tmask], 1.0, atol=1e-8)
    np.testing.assert_allclose(sums[~tmask], 0.0, atol=1e-8)
    want = jx.wfsa_posteriors(jx.full_wfsa(jnp.asarray(trans)), jnp.asarray(inputs),
                              jnp.asarray(li))
    _close(post, want, atol=1e-15)


def test_wfsa_grad_flows_to_weights(rng):
    inputs, trans, _, li, _ = _case(rng)
    fsa = pt.full_wfsa(_t(trans))
    w = fsa.weight.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(pt.wfsa_score(fsa._replace(weight=w), _t(inputs), _t(li)).sum(),
                               w)
    assert torch.isfinite(g).all() and (g != 0).any()
    tr = _t(trans).requires_grad_(True)
    (gt,) = torch.autograd.grad(pt.fcc_score(tr, _t(inputs), _t(li)).sum(), tr)
    n = trans.shape[0]
    _close(g[n:].reshape(n, n), gt.numpy(), rtol=1e-8, atol=1e-10)
    jfsa = jx.full_wfsa(jnp.asarray(trans))
    jg = jax.grad(lambda ww: jx.wfsa_score(jfsa._replace(weight=ww), jnp.asarray(inputs),
                                           jnp.asarray(li)).sum())(jfsa.weight)
    _close(g, jg, atol=1e-15)


def test_lexicon_wfsa_union_matches_fac_logsumexp(rng):
    """Single-word acceptance: the union of chains scores the logsumexp
    over words of each word's force-aligned score."""
    T, N = 10, 6
    inputs = rng.normal(size=(T, 1, N))
    trans = rng.normal(size=(N, N)) * 0.5
    words = [np.asarray(w, np.int32) for w in ([1, 2, 3], [4, 0], [5, 4, 1, 2])]
    weights = rng.normal(size=(len(words),))
    fsa = pt.lexicon_wfsa(_t(trans), words, _t(weights))
    got = pt.wfsa_score(fsa, _t(inputs))
    per_word = [pt.fac_score(_t(trans), _t(inputs), _t(w[None]), _t([T]), _t([len(w)]))[0].item()
                + ww for w, ww in zip(words, weights)]
    ref = float(jax.scipy.special.logsumexp(jnp.asarray(per_word)))
    np.testing.assert_allclose(got[0].item(), ref, rtol=1e-10)
    labs = pt.wfsa_viterbi(fsa, _t(inputs)).labels[:, 0].numpy()
    dedup = [lab for i, lab in enumerate(labs) if i == 0 or lab != labs[i - 1]]
    assert any(dedup == list(w) for w in words)


def test_lexicon_wfsa_loop_brute_force(rng):
    """Continuous recognition (loop=True) vs enumeration of word parses."""
    T, N = 5, 4
    inputs = rng.normal(size=(T, 1, N))
    trans = rng.normal(size=(N, N)) * 0.5
    words = [np.asarray([0, 1], np.int32), np.asarray([2], np.int32)]
    ww = np.asarray([0.3, -0.2])
    got = pt.wfsa_score(pt.lexicon_wfsa(_t(trans), words, _t(ww), loop=True), _t(inputs))

    def parses(path):
        scores = []

        def walk(t, wi, pos, acc):
            y = words[wi][pos]
            if path[t] != y:
                return
            a = acc + inputs[t, 0, y]
            if t == T - 1:
                if pos == len(words[wi]) - 1:
                    scores.append(a)
                return
            walk(t + 1, wi, pos, a + trans[y, y])
            if pos + 1 < len(words[wi]):
                walk(t + 1, wi, pos + 1, a + trans[words[wi][pos + 1], y])
            if pos == len(words[wi]) - 1:
                for wj in range(len(words)):
                    walk(t + 1, wj, 0, a + ww[wj] + trans[words[wj][0], y])

        for wi in range(len(words)):
            walk(0, wi, 0, ww[wi])
        return scores

    all_scores = [s for path in itertools.product(range(N), repeat=T) for s in parses(path)]
    ref = float(jax.scipy.special.logsumexp(jnp.asarray(all_scores)))
    np.testing.assert_allclose(got[0].item(), ref, rtol=1e-9)


# --- each port function against the JAX function on the same graph ------------


def _graphs(rng, trans):
    words = [rng.integers(0, trans.shape[0], size=int(n)).astype(np.int32)
             for n in rng.integers(1, 5, size=6)]
    src, dst, ilab, w, start, final = _tiny_grammar(rng)
    return {
        "full": (pt.full_wfsa(_t(trans)), jx.full_wfsa(jnp.asarray(trans))),
        "lexicon": (pt.lexicon_wfsa(_t(trans), words),
                    jx.lexicon_wfsa(jnp.asarray(trans), words)),
        "lexicon_loop": (pt.lexicon_wfsa(_t(trans), words, loop=True),
                         jx.lexicon_wfsa(jnp.asarray(trans), words, loop=True)),
        "grammar": (pt.WFSA(*(_t(a) for a in (src, dst, ilab, w, start, final))),
                    jx.WFSA(*(jnp.asarray(a) for a in (src, dst, ilab, w, start, final)))),
    }


@pytest.mark.parametrize("graph", ["full", "lexicon", "lexicon_loop", "grammar"])
@pytest.mark.parametrize("integer", [False, True])
def test_port_functions_match_jax(rng, graph, integer):
    """Graph constructors, scores, best paths, arc steps and posteriors on
    one graph; integer inputs make arc ties common (lowest arc id wins)."""
    T, B, N = 8, 3, 5
    if integer:
        inputs = rng.integers(-2, 3, size=(T, B, N)).astype(np.float64)
        trans = rng.integers(-1, 2, size=(N, N)).astype(np.float64)
    else:
        inputs, trans = rng.normal(size=(T, B, N)), rng.normal(size=(N, N))
    li = np.asarray([T, 5, 1], np.int32)
    fsa, jfsa = _graphs(rng, trans)[graph]
    for got, want in zip(fsa, jfsa):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype
    x, jxs = _t(inputs), jnp.asarray(inputs)
    _close(pt.wfsa_score(fsa, x, _t(li)), jx.wfsa_score(jfsa, jxs, jnp.asarray(li)))
    got, want = pt.wfsa_viterbi(fsa, x, _t(li)), jx.wfsa_viterbi(jfsa, jxs, jnp.asarray(li))
    _close(got.scores, want.scores)
    np.testing.assert_array_equal(got.states.numpy(), np.asarray(want.states))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    _close(pt.wfsa_posteriors(fsa, x, _t(li)), jx.wfsa_posteriors(jfsa, jxs, jnp.asarray(li)),
           atol=1e-15)
    alpha = np.where(rng.random((B, fsa.num_states)) < 0.3, -np.inf,
                     rng.integers(-2, 3, size=(B, fsa.num_states)).astype(np.float64))
    best, back = pw._viterbi_arc_step(fsa, _t(alpha), x[0])
    jbest, jback = jw._viterbi_arc_step(jfsa, jnp.asarray(alpha), jxs[0])
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    _close(pw._segment_lse(_t(alpha)[:, :1].expand(B, fsa.num_arcs), fsa.dst, fsa.num_states),
           jw._segment_lse(jnp.broadcast_to(jnp.asarray(alpha)[:, :1], (B, fsa.num_arcs)),
                           jfsa.dst, jfsa.num_states))
    _close(pw._arc_emissions(x[0], fsa.ilabel), jw._arc_emissions(jxs[0], jfsa.ilabel))


def test_lowest_arc_id_wins_ties():
    """Three arcs tie into state 1; the lowest id wins, and the walk reads
    its label."""
    src = _t(np.asarray([0, 0, 0, 1], np.int32))
    dst = _t(np.asarray([1, 1, 1, 1], np.int32))
    ilab = _t(np.asarray([2, 1, 0, 0], np.int32))
    w = _t(np.zeros(4))
    fsa = pt.WFSA(src, dst, ilab, w, _t([0.0, NEG_INF]), _t([NEG_INF, 0.0]))
    x = torch.zeros((1, 1, 3), dtype=torch.float64)
    best, back = pw._viterbi_arc_step(fsa, fsa.start[None], x[0])
    assert back.tolist() == [[2 ** 31 - 1, 0]]  # state 0 has no incoming arc
    assert pt.wfsa_viterbi(fsa, x).labels.tolist() == [[2]]
    x[0, 0, 1] = 1.0  # arc 1 now scores best alone
    assert pt.wfsa_viterbi(fsa, x).labels.tolist() == [[1]]


def test_plan_tables_for_a_skewed_lexicon():
    """A looped lexicon's word starts take an arc from every word end: the
    plan groups states by in-degree and pads each group to its own widest,
    members ascending, each arc exactly once."""
    trans = torch.zeros((6, 6), dtype=torch.float64)
    words = [[1, 2, 3], [4, 0], [5], [1, 5, 2, 3]]
    fsa = pt.lexicon_wfsa(trans, words, loop=True)
    plan = pw._plan(fsa.dst, fsa.num_states)
    assert plan is pw._plan(fsa.dst, fsa.num_states)  # built once
    members = plan.members.numpy()
    real = members[members < fsa.num_arcs]
    assert sorted(real.tolist()) == list(range(fsa.num_arcs))
    dst = fsa.dst.numpy()
    counts = np.bincount(dst, minlength=fsa.num_states)
    widths = sorted(width for _, width in plan.shapes)
    assert widths[-1] == counts.max() and widths[0] <= 2
    assert sum(r * w for r, w in plan.shapes) < fsa.num_states * counts.max()
    off = 0
    for rows, width in plan.shapes:
        table = members[off:off + rows * width].reshape(rows, width)
        off += rows * width
        for row in table:
            ids = row[row < fsa.num_arcs]
            assert (np.diff(ids) > 0).all() and len(set(dst[ids])) <= 1
    assert plan.empty.numpy().tolist() == (counts == 0).tolist()


def test_plan_follows_a_changed_index():
    idx = torch.tensor([0, 1, 1], dtype=torch.int32)
    first = pw._plan(idx, 3)
    idx[0] = 2
    second = pw._plan(idx, 3)
    assert second is not first
    got = pw._segment_sum(torch.ones((1, 3), dtype=torch.float64), second)
    assert got.tolist() == [[0.0, 2.0, 1.0]]


def test_out_of_range_labels_read_nan_as_jax_take():
    x = torch.arange(6, dtype=torch.float64).view(2, 3)
    idx = torch.tensor([2, 3, 0], dtype=torch.int32)
    got = pw._arc_emissions(x, idx)
    want = jw._arc_emissions(jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["wfsa_score", "wfsa_posteriors", "wfsa_viterbi"])
def test_two_runs_give_the_same_bits(rng, fn):
    T, B, N = 12, 4, 6
    inputs = _t(rng.normal(size=(T, B, N)).astype(np.float32))
    trans = _t(rng.normal(size=(N, N)).astype(np.float32))
    words = [rng.integers(0, N, size=int(n)).astype(np.int32)
             for n in rng.integers(2, 6, size=8)]
    fsa = pt.lexicon_wfsa(trans, words, loop=True)
    li = _t(np.asarray([T, 9, 3, 1], np.int32))
    first, second = (getattr(pt, fn)(fsa, inputs, li) for _ in range(2))
    for a, b in zip(*((x,) if isinstance(x, torch.Tensor) else x for x in (first, second))):
        assert torch.equal(a, b)


def test_automaton_on_another_device_raises(rng):
    fsa = pt.full_wfsa(_t(rng.normal(size=(3, 3))))
    with pytest.raises(ValueError, match="emissions' device"):
        pt.wfsa_score(fsa, torch.zeros((2, 1, 3), dtype=torch.float64, device="meta"))


def test_lengths_outside_range_match_jax(rng):
    """The port reads the final combination once, after the last frame (alpha
    froze at each element's end); lengths 0 and T + 1, where no frame is the
    last one, score -inf as in the JAX package, and the posteriors agree."""
    T, B, N = 6, 4, 4
    inputs, trans = rng.normal(size=(T, B, N)), rng.normal(size=(N, N))
    li = np.asarray([0, T + 1, T, 2], np.int32)
    for fsa, jfsa in _graphs(rng, trans).values():
        got = pt.wfsa_score(fsa, _t(inputs), _t(li))
        _close(got, jx.wfsa_score(jfsa, jnp.asarray(inputs), jnp.asarray(li)))
        assert np.isneginf(got[:2].numpy()).all()
        _close(pt.wfsa_posteriors(fsa, _t(inputs), _t(li)),
               jx.wfsa_posteriors(jfsa, jnp.asarray(inputs), jnp.asarray(li)), atol=1e-15)
