"""The PyTorch port's streaming surfaces against the JAX package.

Each test of ``tests/test_streaming.py`` is mirrored: the same inputs, drawn
from a seed with NumPy, stream through the port on CPU tensors at fp64, and
every read-out must equal the JAX package's one-shot function on the
consumed prefix (scores at rtol 1e-12; paths, positions and labels exactly)
as well as the port's own one-shot function.  Not mirrored: the data-mesh
test (the port's ``parallel`` package does not exist yet) and the ``jit``
test (PyTorch runs eagerly).  The per-chunk outputs (backpointers, advance
bits, beam slots, best arcs) must equal the JAX package's update outputs
bit for bit.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops import streaming as jst
from torch_asg_tpu_torch.ops.semiring import ieee_fp32_products

B, N, S = 3, 6, 4
F64 = torch.float64
CPU = "cpu"


def _t(a, dtype=None):
    a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
    return torch.from_numpy(a.copy())


def _j(a, dtype=None):
    return jnp.asarray(np.asarray(a) if dtype is None else np.asarray(a, dtype))


def _problem(rng, t_total=15):
    transition = rng.normal(size=(N, N))
    inputs = rng.normal(size=(t_total, B, N))
    targets = rng.integers(0, N, size=(B, S)).astype(np.int32)
    target_lengths = np.asarray([S, S - 1, S - 2], np.int32)
    return transition, inputs, targets, target_lengths


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _clip(lengths, off, t_c):
    return np.clip(lengths - off, 0, t_c).astype(np.int32)


def _ragged_chunk(inputs, consumed, chunk_lengths, t_c):
    """Each element reads its own next frames."""
    chunk = np.zeros((t_c, B, N))
    for b in range(B):
        for t in range(int(chunk_lengths[b])):
            chunk[t, b] = inputs[consumed[b] + t, b]
    return chunk


def _stream_scores(transition, inputs, splits, targets, target_lengths, lengths=None):
    st = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    off = 0
    for t_c in splits:
        cl = None if lengths is None else _t(_clip(lengths, off, t_c))
        st = pt.streaming_update(_t(transition), st, _t(inputs[off:off + t_c]), _t(targets),
                                 chunk_lengths=cl, target_lengths=_t(target_lengths))
        off += t_c
    return st


@pytest.mark.parametrize("splits", [[15], [5, 5, 5], [1] * 15, [7, 8], [2, 13]])
def test_streaming_matches_oneshot(rng, splits):
    t_total = 15
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    input_lengths = np.full((B,), t_total, np.int32)
    st = _stream_scores(transition, inputs, splits, targets, target_lengths)
    full, aligned = pt.streaming_scores(st, _t(target_lengths))

    _close(full, jx.fcc_score(_j(transition), _j(inputs), _j(input_lengths)))
    _close(aligned, jx.fac_score(_j(transition), _j(inputs), _j(targets), _j(input_lengths),
                                 _j(target_lengths)))
    _close(full, pt.fcc_score(_t(transition), _t(inputs), _t(input_lengths)).numpy())
    _equal(st.frames_seen, input_lengths)
    assert st.frames_seen.dtype == torch.int32


def test_streaming_prefix_scores(rng):
    """After every chunk, the readout equals the one-shot score on the
    prefix consumed so far."""
    t_total = 12
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    st = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    off = 0
    for t_c in [3, 4, 5]:
        st = pt.streaming_update(_t(transition), st, _t(inputs[off:off + t_c]), _t(targets),
                                 target_lengths=_t(target_lengths))
        off += t_c
        pref = np.full((B,), off, np.int32)
        full, aligned = pt.streaming_scores(st, _t(target_lengths))
        _close(full, jx.fcc_score(_j(transition), _j(inputs[:off]), _j(pref)))
        _close(aligned, jx.fac_score(_j(transition), _j(inputs[:off]), _j(targets), _j(pref),
                                     _j(target_lengths)))


def test_streaming_ragged_chunks(rng):
    """Elements advancing at different rates: the final state depends only
    on each element's own consumed prefix."""
    t_total = 10
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    final_lengths = np.asarray([10, 7, 4], np.int32)
    st = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    consumed = np.zeros(B, np.int64)
    for t_c in [4, 3, 3]:
        cl = np.maximum(np.minimum(final_lengths - consumed, t_c), 0).astype(np.int32)
        st = pt.streaming_update(_t(transition), st,
                                 _t(_ragged_chunk(inputs, consumed, cl, t_c)), _t(targets),
                                 chunk_lengths=_t(cl), target_lengths=_t(target_lengths))
        consumed += cl
    full, aligned = pt.streaming_scores(st, _t(target_lengths))
    _close(full, jx.fcc_score(_j(transition), _j(inputs), _j(final_lengths)))
    _close(aligned, jx.fac_score(_j(transition), _j(inputs), _j(targets), _j(final_lengths),
                                 _j(target_lengths)))
    _equal(st.frames_seen, final_lengths)


def test_streaming_precomputed_targets_match(rng):
    """The stream_targets path is bit-identical to the per-chunk
    make_aligned path."""
    t_total = 12
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    pre = pt.streaming_targets(_t(transition), _t(targets), N, _t(target_lengths), dtype=F64)
    st_a = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    st_b = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    cl = _t(np.asarray([4, 3, 2], np.int32))  # ragged tails too
    for off in range(0, t_total, 4):
        chunk = _t(inputs[off:off + 4])
        st_a = pt.streaming_update(_t(transition), st_a, chunk, _t(targets), chunk_lengths=cl,
                                   target_lengths=_t(target_lengths))
        st_b = pt.streaming_update(_t(transition), st_b, chunk, chunk_lengths=cl,
                                   stream_targets=pre)
    for a, b in zip(st_a, st_b):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="targets"):
        pt.streaming_update(_t(transition), st_a, _t(inputs[:2]))


def test_streaming_conflicting_target_args_raise(rng):
    transition, inputs, targets, target_lengths = _problem(rng, 6)
    pre = pt.streaming_targets(_t(transition), _t(targets), N, _t(target_lengths), dtype=F64)
    st = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    with pytest.raises(ValueError, match="not both"):
        pt.streaming_update(_t(transition), st, _t(inputs[:3]), _t(targets),
                            stream_targets=pre)
    with pytest.raises(ValueError, match="not both"):
        pt.streaming_update(_t(transition), st, _t(inputs[:3]),
                            target_lengths=_t(target_lengths), stream_targets=pre)


def test_streaming_bf16_chunks_upcast_to_oneshot_parity(rng):
    """bf16 chunks upcast at the boundary; the carry dtype stays float32."""
    t_total = 10
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    tr32 = _t(transition).float()
    bf = _t(inputs).bfloat16()
    st = pt.streaming_init(B, N, S, dtype=torch.bfloat16, device=CPU)
    assert st.alpha_full.dtype == torch.float32
    vst = pt.streaming_viterbi_init(B, N, dtype=torch.bfloat16, device=CPU)
    assert vst.delta.dtype == torch.float32
    bps, vals = [], []
    for off in range(0, t_total, 5):
        st = pt.streaming_update(tr32, st, bf[off:off + 5], _t(targets),
                                 target_lengths=_t(target_lengths))
        vst, (bp, v) = pt.streaming_viterbi_update(tr32, vst, bf[off:off + 5])
        bps.append(bp)
        vals.append(v)
    full, _ = pt.streaming_scores(st, _t(target_lengths))
    f32 = bf.float()
    want = jx.fcc_score(_j(tr32.numpy()), _j(f32.numpy()), _j(np.full((B,), t_total, np.int32)))
    _close(full, want, rtol=1e-5)
    got = pt.streaming_viterbi_backtrace(vst, torch.cat(bps), torch.cat(vals))
    _equal(got.paths, jx.viterbi_decode(_j(tr32.numpy()), _j(f32.numpy())).paths)
    _equal(got.paths, pt.viterbi_decode(tr32, f32).paths)


def test_streaming_aligned_inf_until_coverable(rng):
    transition, inputs, targets, target_lengths = _problem(rng, 8)
    st = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    st = pt.streaming_update(_t(transition), st, _t(inputs[:2]), _t(targets),
                             target_lengths=_t(target_lengths))
    full, aligned = pt.streaming_scores(st, _t(target_lengths))
    # lengths are [4, 3, 2]: after 2 frames only element 2 is coverable
    assert np.isneginf(aligned[0].item()) and np.isneginf(aligned[1].item())
    assert np.isfinite(aligned[2].item())
    assert torch.isfinite(full).all()


def _stream_viterbi(transition, inputs, splits, lengths=None):
    st = pt.streaming_viterbi_init(B, N, dtype=F64, device=CPU)
    bps, vals, off = [], [], 0
    for t_c in splits:
        cl = None if lengths is None else _t(_clip(lengths, off, t_c))
        st, (bp, v) = pt.streaming_viterbi_update(_t(transition), st,
                                                  _t(inputs[off:off + t_c]), chunk_lengths=cl)
        bps.append(bp)
        vals.append(v)
        off += t_c
    return pt.streaming_viterbi_backtrace(st, torch.cat(bps), torch.cat(vals))


@pytest.mark.parametrize("splits", [[12], [4, 4, 4], [1] * 12, [5, 7]])
def test_streaming_viterbi_matches_oneshot(rng, splits):
    t_total = 12
    transition, inputs, _, _ = _problem(rng, t_total)
    input_lengths = np.full((B,), t_total, np.int32)
    got = _stream_viterbi(transition, inputs, splits)
    want = jx.viterbi_decode(_j(transition), _j(inputs), _j(input_lengths))
    _close(got.scores, want.scores)
    _equal(got.paths, want.paths)
    assert got.paths.dtype == torch.int32


def _own_prefix_equal(got_paths, want_paths):
    """Each element's emitted labels (stream order, -1 skipped) equal the
    one-shot path over its own prefix."""
    got_paths, want_paths = got_paths.numpy(), np.asarray(want_paths)
    for b in range(got_paths.shape[1]):
        np.testing.assert_array_equal(got_paths[:, b][got_paths[:, b] >= 0],
                                      want_paths[:, b][want_paths[:, b] >= 0])


def test_streaming_viterbi_ragged(rng):
    t_total = 9
    transition, inputs, _, _ = _problem(rng, t_total)
    final_lengths = np.asarray([9, 6, 3])
    st = pt.streaming_viterbi_init(B, N, dtype=F64, device=CPU)
    bps, vals = [], []
    consumed = np.zeros(B, np.int64)
    for t_c in [4, 3, 2]:
        cl = np.minimum(final_lengths - consumed, t_c).clip(0)
        st, (bp, v) = pt.streaming_viterbi_update(
            _t(transition), st, _t(_ragged_chunk(inputs, consumed, cl, t_c)),
            chunk_lengths=_t(cl, np.int32))
        bps.append(bp)
        vals.append(v)
        consumed += cl
    got = pt.streaming_viterbi_backtrace(st, torch.cat(bps), torch.cat(vals))
    want = jx.viterbi_decode(_j(transition), _j(inputs), _j(final_lengths, np.int32))
    _close(got.scores, want.scores)
    _own_prefix_equal(got.paths, want.paths)


def test_streaming_viterbi_partial_and_empty(rng):
    t_total = 8
    transition, inputs, _, _ = _problem(rng, t_total)
    st = pt.streaming_viterbi_init(B, N, dtype=F64, device=CPU)
    cl = np.asarray([5, 3, 0], np.int32)  # element 2 consumes nothing
    st, (bp, v) = pt.streaming_viterbi_update(_t(transition), st, _t(inputs[:5]),
                                              chunk_lengths=_t(cl))
    got = pt.streaming_viterbi_backtrace(st, bp, v)
    want = jx.viterbi_decode(_j(transition), _j(inputs[:5]), _j(cl))
    _close(got.scores[:2], np.asarray(want.scores)[:2])
    _own_prefix_equal(got.paths[:, :2], np.asarray(want.paths)[:, :2])
    assert np.isneginf(got.scores[2].item())
    assert (got.paths[:, 2] == -1).all()


@pytest.mark.parametrize("splits", [[12], [5, 4, 3], [1] * 12])
def test_streaming_nbest_matches_oneshot(rng, splits):
    t_total, k = 12, 3
    transition, inputs, _, _ = _problem(rng, t_total)
    lengths = np.asarray([12, 8, 5], np.int32)
    st = pt.streaming_nbest_init(B, N, k, dtype=F64, device=CPU)
    bps, vals, off = [], [], 0
    for t_c in splits:
        st, (bp, v) = pt.streaming_nbest_update(_t(transition), st, _t(inputs[off:off + t_c]),
                                                chunk_lengths=_t(_clip(lengths, off, t_c)))
        bps.append(bp)
        vals.append(v)
        off += t_c
    got = pt.streaming_nbest_backtrace(st, torch.cat(bps), torch.cat(vals))
    want = jx.viterbi_nbest(_j(transition), _j(inputs), k, _j(lengths))
    _close(got.scores, want.scores)
    gp, wp = got.paths.numpy(), np.asarray(want.paths)
    for b in range(B):
        for r in range(k):
            np.testing.assert_array_equal(gp[:, b, r][gp[:, b, r] >= 0],
                                          wp[:, b, r][wp[:, b, r] >= 0])


def _stream_align(transition, inputs, splits, targets, target_lengths, lengths):
    st = pt.streaming_align_init(B, S, dtype=F64, device=CPU)
    advs, vals, off = [], [], 0
    for t_c in splits:
        st, (adv, v) = pt.streaming_align_update(
            _t(transition), st, _t(inputs[off:off + t_c]), _t(targets),
            chunk_lengths=_t(_clip(lengths, off, t_c)), target_lengths=_t(target_lengths))
        advs.append(adv)
        vals.append(v)
        off += t_c
    return st, torch.cat(advs), torch.cat(vals)


def _check_alignment(got, want):
    _close(got.scores, want.scores)
    _equal(got.positions, want.positions)
    _equal(got.labels, want.labels)


@pytest.mark.parametrize("splits", [[12], [4, 4, 4], [1] * 12, [5, 7]])
def test_streaming_align_matches_oneshot(rng, splits):
    t_total = 12
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    lengths = np.asarray([12, 9, 6], np.int32)
    st, adv, v = _stream_align(transition, inputs, splits, targets, target_lengths, lengths)
    got = pt.streaming_align_backtrace(st, adv, v, _t(targets),
                                       target_lengths=_t(target_lengths))
    _check_alignment(got, jx.viterbi_align(_j(transition), _j(inputs), _j(targets),
                                           _j(lengths), _j(target_lengths)))
    _check_alignment(got, pt.viterbi_align(_t(transition), _t(inputs), _t(targets),
                                           _t(lengths), _t(target_lengths)))


def test_streaming_align_stream_targets_precompute(rng):
    t_total = 10
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    pre = pt.streaming_targets(_t(transition), _t(targets), N, _t(target_lengths), dtype=F64)
    st_a = pt.streaming_align_init(B, S, dtype=F64, device=CPU)
    st_b = pt.streaming_align_init(B, S, dtype=F64, device=CPU)
    advs, vals = [], []
    for off in (0, 5):
        chunk = _t(inputs[off:off + 5])
        st_a, (adv_a, v_a) = pt.streaming_align_update(_t(transition), st_a, chunk,
                                                       stream_targets=pre)
        st_b, (adv_b, v_b) = pt.streaming_align_update(_t(transition), st_b, chunk,
                                                       _t(targets),
                                                       target_lengths=_t(target_lengths))
        assert torch.equal(adv_a, adv_b)
        advs.append(adv_a)
        vals.append(v_a)
    assert torch.equal(st_a.delta, st_b.delta)
    got = pt.streaming_align_backtrace(st_a, torch.cat(advs), torch.cat(vals),
                                       stream_targets=pre, target_lengths=_t(target_lengths))
    _check_alignment(got, jx.viterbi_align(_j(transition), _j(inputs), _j(targets),
                                           _j(np.full((B,), t_total, np.int32)),
                                           _j(target_lengths)))
    with pytest.raises(ValueError, match="not both"):
        pt.streaming_align_update(_t(transition), st_a, _t(inputs[:2]), _t(targets),
                                  stream_targets=pre)


def test_streaming_align_partial_and_empty(rng):
    t_total = 8
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    st = pt.streaming_align_init(B, S, dtype=F64, device=CPU)
    cl = np.asarray([5, 3, 0], np.int32)
    st, (adv, v) = pt.streaming_align_update(_t(transition), st, _t(inputs[:5]), _t(targets),
                                             chunk_lengths=_t(cl),
                                             target_lengths=_t(target_lengths))
    got = pt.streaming_align_backtrace(st, adv, v, _t(targets),
                                       target_lengths=_t(target_lengths))
    want = jx.viterbi_align(_j(transition), _j(inputs[:5]), _j(targets), _j(cl),
                            _j(target_lengths))
    _close(got.scores[:2], np.asarray(want.scores)[:2])
    _equal(got.positions[:, :2], np.asarray(want.positions)[:, :2])
    assert np.isneginf(got.scores[2].item())
    assert (got.positions[:, 2] == -1).all()


def _chain_pair(rng):
    labels = rng.integers(0, N, size=(3,)).astype(np.int32)
    self_w, next_w = rng.normal(size=(3,)), rng.normal(size=(3,))
    return (pt.chain_wfsa(_t(labels), _t(self_w), _t(next_w)),
            jx.chain_wfsa(_j(labels), _j(self_w), _j(next_w)))


@pytest.mark.parametrize("splits", [[10], [4, 3, 3], [1] * 10])
def test_streaming_wfsa_matches_oneshot(rng, splits):
    t_total = 10
    transition = rng.normal(size=(N, N))
    inputs = rng.normal(size=(t_total, B, N))
    lengths = np.asarray([10, 7, 4], np.int32)
    chain = _chain_pair(rng)
    for fsa, jfsa in ((pt.full_wfsa(_t(transition)), jx.full_wfsa(_j(transition))), chain):
        st = pt.streaming_wfsa_init(fsa, B, dtype=F64, device=CPU)
        off = 0
        for t_c in splits:
            st = pt.streaming_wfsa_update(fsa, st, _t(inputs[off:off + t_c]),
                                          chunk_lengths=_t(_clip(lengths, off, t_c)))
            off += t_c
        got = pt.streaming_wfsa_scores(fsa, st)
        _close(got, jx.wfsa_score(jfsa, _j(inputs), _j(lengths)))
        _close(got, pt.wfsa_score(fsa, _t(inputs), _t(lengths)).numpy())
        _equal(st.frames_seen, lengths)


def test_streaming_grads_finite_on_dead_band_rows(rng):
    """Differentiating the streaming prefix loss stays NaN-free with dead
    band rows present, and equals the JAX package's gradient."""
    t_total = 6
    transition, inputs, targets, target_lengths = _problem(rng, t_total)

    def prefix_loss(tr, x, lib):
        if lib is pt:
            st = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
            upd = lambda st, c: pt.streaming_update(tr, st, c, _t(targets),
                                                    target_lengths=_t(target_lengths))
            where = torch.where
            isfinite = torch.isfinite
        else:
            st = jst.streaming_init(B, N, S, dtype=jnp.float64)
            upd = lambda st, c: jst.streaming_update(tr, st, c, _j(targets),
                                                     target_lengths=_j(target_lengths))
            where, isfinite = jnp.where, jnp.isfinite
        st = upd(st, x[:3])
        st = upd(st, x[3:])
        full, aligned = lib.streaming_scores(st, (_t if lib is pt else _j)(target_lengths))
        return where(isfinite(aligned), full - aligned, full).sum()

    tr = _t(transition).requires_grad_(True)
    x = _t(inputs).requires_grad_(True)
    val = prefix_loss(tr, x, pt)
    g_t, g_i = torch.autograd.grad(val, (tr, x))
    assert np.isfinite(val.item())
    assert torch.isfinite(g_t).all() and torch.isfinite(g_i).all()
    jval, (jg_t, jg_i) = jax.value_and_grad(prefix_loss, argnums=(0, 1))(
        _j(transition), _j(inputs), jx)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(jg_t), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(g_i.numpy(), np.asarray(jg_i), rtol=1e-10, atol=1e-12)


def test_streaming_targets_promotes_precompute_dtype(rng):
    """A float64 transition with no dtype keeps the precompute in float64."""
    transition, inputs, targets, target_lengths = _problem(rng, 8)
    pre = pt.streaming_targets(_t(transition), _t(targets), N, _t(target_lengths))
    assert pre.e_t.dtype == F64
    st = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    for off in range(0, 8, 4):
        st = pt.streaming_update(_t(transition), st, _t(inputs[off:off + 4]),
                                 stream_targets=pre)
    full, _ = pt.streaming_scores(st, _t(target_lengths))
    _close(full, jx.fcc_score(_j(transition), _j(inputs), _j(np.full((B,), 8, np.int32))))


def test_streaming_update_rejects_downcasting_precompute(rng):
    transition, inputs, targets, target_lengths = _problem(rng, 4)
    pre = pt.streaming_targets(_t(transition).float(), _t(targets), N, _t(target_lengths),
                               dtype=torch.float32)
    st = pt.streaming_init(B, N, S, dtype=F64, device=CPU)
    with pytest.raises(ValueError, match="precomputed at"):
        pt.streaming_update(_t(transition), st, _t(inputs[:4]), stream_targets=pre)


def test_streaming_align_rejects_downcasting_precompute(rng):
    transition, inputs, targets, target_lengths = _problem(rng, 4)
    pre = pt.streaming_targets(_t(transition).float(), _t(targets), N, _t(target_lengths),
                               dtype=torch.float32)
    st = pt.streaming_align_init(B, S, dtype=F64, device=CPU)
    with pytest.raises(ValueError, match="precomputed at"):
        pt.streaming_align_update(_t(transition), st, _t(inputs[:4]), stream_targets=pre)


def test_streaming_f64_precompute_feeds_f32_state(rng):
    """A float64 precompute feeding a float32 state is cast down to the
    state's dtype and matches the one-shot float32 path."""
    t_total = 8
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    pre = pt.streaming_targets(_t(transition), _t(targets), N, _t(target_lengths))
    assert pre.self_trans.dtype == F64
    st = pt.streaming_init(B, N, S, device=CPU)
    sta = pt.streaming_align_init(B, S, device=CPU)
    advs, vals = [], []
    for off in range(0, t_total, 4):
        chunk = _t(inputs[off:off + 4]).float()
        st = pt.streaming_update(_t(transition), st, chunk, stream_targets=pre)
        sta, (adv, v) = pt.streaming_align_update(_t(transition), sta, chunk,
                                                  stream_targets=pre)
        advs.append(adv)
        vals.append(v)
    assert st.alpha_full.dtype == torch.float32 and sta.delta.dtype == torch.float32
    tr32, in32 = transition.astype(np.float32), inputs.astype(np.float32)
    li = np.full((B,), t_total, np.int32)
    full, aligned = pt.streaming_scores(st, _t(target_lengths))
    _close(full, jx.fcc_score(_j(tr32), _j(in32), _j(li)), rtol=2e-5)
    _close(aligned, jx.fac_score(_j(tr32), _j(in32), _j(targets), _j(li), _j(target_lengths)),
           rtol=2e-5)
    got = pt.streaming_align_backtrace(sta, torch.cat(advs), torch.cat(vals),
                                       stream_targets=pre)
    want = jx.viterbi_align(_j(tr32), _j(in32), _j(targets), _j(li), _j(target_lengths))
    _close(got.scores, want.scores, rtol=2e-5)
    _equal(got.positions, want.positions)


def test_streaming_align_backtrace_derives_ragged_lengths(rng):
    t_total = 10
    transition, inputs, targets, target_lengths = _problem(rng, t_total)
    assert target_lengths.min() < S
    pre = pt.streaming_targets(_t(transition), _t(targets), N, _t(target_lengths), dtype=F64)
    st = pt.streaming_align_init(B, S, dtype=F64, device=CPU)
    st, (adv, v) = pt.streaming_align_update(_t(transition), st, _t(inputs),
                                             stream_targets=pre)
    got = pt.streaming_align_backtrace(st, adv, v, stream_targets=pre)
    _check_alignment(got, jx.viterbi_align(_j(transition), _j(inputs), _j(targets),
                                           _j(np.full((B,), t_total, np.int32)),
                                           _j(target_lengths)))


def _stream_beam(transition, inputs, splits, k, lengths=None):
    st = pt.streaming_beam_init(B, k, dtype=F64, device=CPU)
    labs, bps, vals, off = [], [], [], 0
    for t_c in splits:
        cl = None if lengths is None else _t(_clip(lengths, off, t_c))
        st, (lab, bp, v) = pt.streaming_beam_update(_t(transition), st,
                                                    _t(inputs[off:off + t_c]), chunk_lengths=cl)
        labs.append(lab)
        bps.append(bp)
        vals.append(v)
        off += t_c
    return st, torch.cat(labs), torch.cat(bps), torch.cat(vals)


@pytest.mark.parametrize("splits", [[12], [4, 4, 4], [1] * 12, [7, 5]])
def test_streaming_beam_matches_oneshot(rng, splits):
    t_total, k = 12, 3
    transition, inputs, _, _ = _problem(rng, t_total)
    lengths = np.asarray([12, 8, 3], np.int32)
    got = pt.streaming_beam_backtrace(*_stream_beam(transition, inputs, splits, k, lengths))
    want = jx.beam_decode(_j(transition), _j(inputs), _j(lengths), beam_size=k)
    _close(got.scores, want.scores)
    _equal(got.paths, want.paths)
    mine = pt.beam_decode(_t(transition), _t(inputs), _t(lengths), beam_size=k)
    assert torch.equal(got.paths, mine.paths) and torch.equal(got.scores, mine.scores)


def test_streaming_beam_partial_and_empty(rng):
    t_total, k = 10, 2
    transition, inputs, _, _ = _problem(rng, t_total)
    cl = np.asarray([5, 3, 0], np.int32)
    st = pt.streaming_beam_init(B, k, dtype=F64, device=CPU)
    st, (lab, bp, v) = pt.streaming_beam_update(_t(transition), st, _t(inputs[:5]),
                                                chunk_lengths=_t(cl))
    got = pt.streaming_beam_backtrace(st, lab, bp, v)
    for b in range(2):
        length = int(cl[b])
        w = jx.beam_decode(_j(transition), _j(inputs[:length]),
                           _j(np.full((B,), length, np.int32)), beam_size=k)
        _close(got.scores[b], np.asarray(w.scores)[b])
        _equal(got.paths[:length, b], np.asarray(w.paths)[:length, b])
    assert np.isneginf(got.scores[2].item())
    assert (got.paths[:, 2] == -1).all()
    with pytest.raises(ValueError, match="beam_size"):
        pt.streaming_beam_init(B, 0, device=CPU)


def test_streaming_beam_wider_than_vocab(rng):
    t_total, k = 8, N + 3
    transition, inputs, _, _ = _problem(rng, t_total)
    st, labs, bps, vals = _stream_beam(transition, inputs, [4, 4], k)
    assert np.isneginf(st.delta[:, N:].numpy()).all()
    got = pt.streaming_beam_backtrace(st, labs, bps, vals)
    want = jx.beam_decode(_j(transition), _j(inputs), _j(np.full((B,), t_total, np.int32)),
                          beam_size=k)
    _close(got.scores, want.scores)
    _equal(got.paths, want.paths)


@pytest.mark.parametrize("splits", [[10], [4, 3, 3], [1] * 10])
def test_streaming_wfsa_viterbi_matches_oneshot(rng, splits):
    """Streaming WFSA best path == one-shot wfsa_viterbi on the consumed
    prefix (lowest-arc-id ties), for a full automaton and a lexicon."""
    t_total = 10
    transition = rng.normal(size=(N, N))
    inputs = rng.normal(size=(t_total, B, N))
    lengths = np.asarray([10, 7, 4], np.int32)
    words = [rng.integers(0, N, size=(3,)).astype(np.int32),
             rng.integers(0, N, size=(2,)).astype(np.int32)]
    pairs = ((pt.full_wfsa(_t(transition)), jx.full_wfsa(_j(transition))),
             (pt.lexicon_wfsa(_t(transition), words), jx.lexicon_wfsa(_j(transition), words)))
    for fsa, jfsa in pairs:
        st = pt.streaming_wfsa_viterbi_init(fsa, B, dtype=F64, device=CPU)
        backs, vals, off = [], [], 0
        for t_c in splits:
            st, (bk, v) = pt.streaming_wfsa_viterbi_update(
                fsa, st, _t(inputs[off:off + t_c]), chunk_lengths=_t(_clip(lengths, off, t_c)))
            backs.append(bk)
            vals.append(v)
            off += t_c
        got = pt.streaming_wfsa_viterbi_backtrace(fsa, st, torch.cat(backs), torch.cat(vals))
        want = jx.wfsa_viterbi(jfsa, _j(inputs), _j(lengths))
        _close(got.scores, want.scores)
        _equal(got.states, want.states)
        _equal(got.labels, want.labels)


def test_streaming_wfsa_viterbi_partial_and_empty(rng):
    t_total = 8
    transition = rng.normal(size=(N, N))
    inputs = rng.normal(size=(t_total, B, N))
    fsa, jfsa = pt.full_wfsa(_t(transition)), jx.full_wfsa(_j(transition))
    cl = np.asarray([5, 3, 0], np.int32)
    st = pt.streaming_wfsa_viterbi_init(fsa, B, dtype=F64, device=CPU)
    st, (bk, v) = pt.streaming_wfsa_viterbi_update(fsa, st, _t(inputs[:5]),
                                                   chunk_lengths=_t(cl))
    got = pt.streaming_wfsa_viterbi_backtrace(fsa, st, bk, v)
    for b in range(2):
        length = int(cl[b])
        want = jx.wfsa_viterbi(jfsa, _j(inputs[:length]), _j(np.full((B,), length, np.int32)))
        _close(got.scores[b], np.asarray(want.scores)[b])
        _equal(got.labels[:length, b], np.asarray(want.labels)[:, b])
    empty = float(jnp.max(jfsa.start + jfsa.final))
    np.testing.assert_allclose(got.scores[2].item(), empty, rtol=1e-12)
    assert (got.labels[:, 2] == -1).all() and (got.states[:, 2] == -1).all()


@pytest.mark.parametrize("splits", [[12], [4, 4, 4], [7, 5]])
def test_streaming_beam_nbest_matches_oneshot(rng, splits):
    t_total, k, n = 12, 4, 3
    transition, inputs, _, _ = _problem(rng, t_total)
    lengths = np.asarray([12, 8, 3], np.int32)
    st, labs, bps, vals = _stream_beam(transition, inputs, splits, k, lengths)
    got = pt.streaming_beam_nbest_backtrace(st, labs, bps, vals, n)
    want = jx.beam_nbest(_j(transition), _j(inputs), n, _j(lengths), beam_size=k)
    _close(got.scores, want.scores)
    _equal(got.paths, want.paths)
    with pytest.raises(ValueError, match="beam_size"):
        pt.streaming_beam_nbest_backtrace(st, labs, bps, vals, k + 1)


# --- the port's own contracts -------------------------------------------------


def _jax_updates(transition, inputs, targets, target_lengths, lengths, fsa):
    """Each JAX update's per-chunk outputs on one ragged chunk."""
    tr, x, cl = _j(transition), _j(inputs), _j(lengths)
    tg, lo = _j(targets), _j(target_lengths)
    return {
        "viterbi": jst.streaming_viterbi_update(
            tr, jst.streaming_viterbi_init(B, N, jnp.float64), x, cl)[1],
        "beam": jst.streaming_beam_update(
            tr, jst.streaming_beam_init(B, 4, jnp.float64), x, cl)[1],
        "nbest": jst.streaming_nbest_update(
            tr, jst.streaming_nbest_init(B, N, 3, jnp.float64), x, cl)[1],
        "align": jst.streaming_align_update(
            tr, jst.streaming_align_init(B, S, jnp.float64), x, tg, cl, lo)[1],
        "wfsa_viterbi": jst.streaming_wfsa_viterbi_update(
            fsa, jst.streaming_wfsa_viterbi_init(fsa, B, jnp.float64), x, cl)[1],
    }


def test_update_outputs_match_jax(rng):
    """Every per-chunk output (backpointers, beam labels and slots, advance
    bits, best arcs, validity) equals the JAX package's, bit for bit,
    integer ties included; so do the carried states."""
    t_total = 9
    transition = rng.integers(-1, 2, size=(N, N)).astype(np.float64)
    inputs = rng.integers(-2, 3, size=(t_total, B, N)).astype(np.float64)
    targets = rng.integers(0, N, size=(B, S)).astype(np.int32)
    target_lengths = np.asarray([S, 2, 1], np.int32)
    lengths = np.asarray([9, 5, 0], np.int32)
    words = [np.asarray([1, 2, 3], np.int32), np.asarray([4, 1], np.int32)]
    want = _jax_updates(transition, inputs, targets, target_lengths, lengths,
                        jx.lexicon_wfsa(_j(transition), words, loop=True))
    tr, x, cl = _t(transition), _t(inputs), _t(lengths)
    fsa = pt.lexicon_wfsa(tr, words, loop=True)
    got = {
        "viterbi": pt.streaming_viterbi_update(
            tr, pt.streaming_viterbi_init(B, N, F64, device=CPU), x, cl)[1],
        "beam": pt.streaming_beam_update(
            tr, pt.streaming_beam_init(B, 4, F64, device=CPU), x, cl)[1],
        "nbest": pt.streaming_nbest_update(
            tr, pt.streaming_nbest_init(B, N, 3, F64, device=CPU), x, cl)[1],
        "align": pt.streaming_align_update(
            tr, pt.streaming_align_init(B, S, F64, device=CPU), x, _t(targets), cl,
            _t(target_lengths))[1],
        "wfsa_viterbi": pt.streaming_wfsa_viterbi_update(
            fsa, pt.streaming_wfsa_viterbi_init(fsa, B, F64, device=CPU), x, cl)[1],
    }
    for name in want:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_update_raises_on_a_chunk_on_another_device(rng):
    transition, inputs, targets, target_lengths = _problem(rng, 4)
    chunk = _t(inputs).to("meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        pt.streaming_update(_t(transition), pt.streaming_init(B, N, S, F64, device=CPU),
                            chunk, _t(targets))
    with pytest.raises(ValueError, match="lies on cpu"):
        pt.streaming_viterbi_update(_t(transition),
                                    pt.streaming_viterbi_init(B, N, F64, device=CPU), chunk)
    fsa = pt.full_wfsa(_t(transition))
    with pytest.raises(ValueError, match="lies on cpu"):
        pt.streaming_wfsa_update(fsa, pt.streaming_wfsa_init(fsa, B, F64, device=CPU), chunk)


@pytest.mark.parametrize("init", [n for n in pt.__all__
                                  if n.startswith("streaming_") and n.endswith("_init")])
def test_init_defaults_to_the_card(init):
    assert inspect.signature(getattr(pt, init)).parameters["device"].default == "cuda"


def test_align_scores_neg_inf_outside_target_range(rng):
    """Where no alignment exists (target length 0, or past S) the streaming
    alignment scores -inf, as the port's one-shot ``viterbi_align`` does
    (the JAX streaming read-out gives 0.0 there); positions and labels are
    the JAX package's."""
    t_total = 7
    transition, inputs, targets, _ = _problem(rng, t_total)
    lo = np.asarray([0, S + 1, 2], np.int32)
    lengths = np.full((B,), t_total, np.int32)
    st, adv, v = _stream_align(transition, inputs, [3, 4], targets, lo, lengths)
    got = pt.streaming_align_backtrace(st, adv, v, _t(targets), target_lengths=_t(lo))
    jst_ = jst.streaming_align_init(B, S, jnp.float64)
    jst_, (jadv, jv) = jst.streaming_align_update(_j(transition), jst_, _j(inputs),
                                                  _j(targets), target_lengths=_j(lo))
    want = jst.streaming_align_backtrace(jst_, jadv, jv, _j(targets), target_lengths=_j(lo))
    assert np.isneginf(got.scores[:2].numpy()).all()
    np.testing.assert_array_equal(np.asarray(want.scores)[:2], 0.0)
    _close(got.scores[2:], np.asarray(want.scores)[2:])
    _equal(got.positions, want.positions)
    _equal(got.labels, want.labels)
    one_shot = pt.viterbi_align(_t(transition), _t(inputs), _t(targets), _t(lengths), _t(lo))
    assert torch.equal(got.scores, one_shot.scores)


def test_fcc_step_products_in_full_fp32():
    """The FCC step's products run with TF32 off, and the caller's setting
    comes back after."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        with ieee_fp32_products():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = prev


def test_streaming_launches_no_kernel(rng, monkeypatch):
    """The streaming steps are plain PyTorch: no kernel wrapper of the port
    is called, not even on the paths the one-shot decoders share.  Every
    module of the port that holds a wrapper gets a stub in its place."""
    import sys

    from torch_asg_tpu_torch.ops.kernels import (asg_kernels, bigvocab_kernels, fac_kernels,
                                                 fcc_kernels, viterbi_kernels)

    def boom(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    wrappers = {id(getattr(mod, name)) for mod in (asg_kernels, bigvocab_kernels, fac_kernels,
                                                   fcc_kernels, viterbi_kernels)
                for name in dir(mod)
                if name.endswith("_pallas") or name in ("asg_scores_fused", "fcc_dual_streams")}
    patched = 0
    for mod_name, mod in list(sys.modules.items()):
        if mod_name.startswith("torch_asg_tpu_torch"):
            for name, value in list(vars(mod).items()):
                if id(value) in wrappers:
                    monkeypatch.setattr(mod, name, boom)
                    patched += 1
    assert patched >= len(wrappers)
    transition, inputs, targets, target_lengths = _problem(rng, 6)
    st = _stream_scores(transition, inputs, [3, 3], targets, target_lengths)
    assert torch.isfinite(pt.streaming_scores(st, _t(target_lengths))[0]).all()
    _stream_viterbi(transition, inputs, [3, 3])
    _stream_beam(transition, inputs, [3, 3], 2)
    _stream_align(transition, inputs, [3, 3], targets, target_lengths,
                  np.full((B,), 6, np.int32))
