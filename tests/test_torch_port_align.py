"""The PyTorch port's forced aligner against the JAX package's.

The port's ``'pallas'`` tier runs the plain versions of its CUDA kernels
(K12 forward, K13 backtrace) on CPU tensors; the JAX package's runs its
Pallas kernels in interpret mode.  Positions, labels and advance bits must
be bit-identical, stay/advance ties included, with -1 at padding frames;
scores agree to rtol 1e-12 (fp64).  Mirrors ``tests/test_viterbi.py``'s
alignment tests.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops import fac as jfac
from torch_asg_tpu.ops.pallas import viterbi_kernels as jvk
from torch_asg_tpu_torch.ops import fac as pfac
from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as pvk
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES
from torch_asg_tpu_torch.ops.viterbi import ALIGN_KERNEL_MAX_WIDTH


def _case(seed, t_total=19, num_batches=5, num_labels=6, s_total=4, tie=False):
    rng = np.random.default_rng(seed)
    if tie:
        # zero transitions and one emission value per frame: stay and advance
        # tie at every step
        inputs = np.tile(rng.normal(size=(t_total, num_batches, 1)), (1, 1, num_labels))
        trans = np.zeros((num_labels, num_labels))
    else:
        inputs = rng.normal(size=(t_total, num_batches, num_labels))
        trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    li = np.array([t_total, 12, 1, 9, t_total][:num_batches], np.int32)
    lo = np.array([s_total, 3, 1, 2, s_total][:num_batches], np.int32)
    return trans, inputs, targets, li, lo


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _check_align(case, jax_impl="xla"):
    want = jx.viterbi_align(*_jax(*case), impl=jax_impl)
    for impl in ("xla", "pallas"):
        got = pt.viterbi_align(*_torch(*case), impl=impl)
        assert got.positions.dtype == torch.int32 and got.labels.dtype == torch.int32
        np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-12)
    return got


@pytest.mark.parametrize("seed", range(2))
def test_align_matches_jax_ragged(seed):
    """Ragged lengths with a one-frame element; -1 past each L_in."""
    case = _case(seed)
    got = _check_align(case)
    for b, length in enumerate(case[3]):
        assert (got.positions[length:, b] == -1).all()
        assert (got.labels[length:, b] == -1).all()


def test_align_matches_jax_pallas_tier():
    _check_align(_case(2), jax_impl="pallas")


def test_align_ties_stay():
    """Exact stay/advance ties go to staying in every tier of both packages
    (full lengths, as test_viterbi.py's tie case)."""
    trans, inputs, targets, _, _ = _case(3, t_total=11, num_batches=3, num_labels=4,
                                         s_total=3, tie=True)
    _check_align((trans, inputs, targets, np.full(3, 11, np.int32), np.full(3, 3, np.int32)))


def _brute_force_align(transition, inputs, y, length):
    """Best score over every monotonic alignment of y to ``length`` frames."""
    best = -np.inf
    for steps in itertools.product((0, 1), repeat=length - 1):
        pos = np.concatenate([[0], np.cumsum(steps)])
        if pos[-1] != len(y) - 1:
            continue
        score = inputs[0, y[0]] + sum(transition[y[pos[t]], y[pos[t - 1]]] + inputs[t, y[pos[t]]]
                                      for t in range(1, length))
        best = max(best, score)
    return best


@pytest.mark.parametrize("seed", range(3))
def test_align_brute_force(seed):
    """test_viterbi.py's brute-force cases, ragged: each tier's score is the
    best alignment's, and its positions are a valid alignment scoring it."""
    rng = np.random.default_rng(seed)
    t_total, num_batches, num_labels, s_total = 6, 2, 4, 3
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels))
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    li, lo = np.array([6, 4], np.int32), np.array([3, 2], np.int32)
    for impl in ("xla", "pallas"):
        res = pt.viterbi_align(*_torch(trans, inputs, targets, li, lo), impl=impl)
        for b in range(num_batches):
            y = targets[b, :lo[b]]
            want = _brute_force_align(trans, inputs[:, b], y, li[b])
            np.testing.assert_allclose(float(res.scores[b]), want, rtol=1e-12)
            pos = res.positions[:li[b], b].numpy()
            assert pos[0] == 0 and pos[-1] == lo[b] - 1
            assert set(np.diff(pos)) <= {0, 1}
            assert (res.positions[li[b]:, b] == -1).all()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_target_lengths_outside_range_score_neg_inf(impl):
    """An element with no alignment scores -inf on both port tiers.  At
    L_out = 0 (an empty transcript, which ``encode_targets`` gives) the
    scores, positions and labels equal the JAX ``'xla'`` tier's, -inf
    included.  At L_out > S the port scores -inf where the JAX ``'xla'``
    tier gives NaN (``take_along_axis`` fills past the end) and its
    ``'pallas'`` tier 0.0: a deliberate deviation, recorded in ROADMAP
    Queue 3; positions and labels still equal the JAX ``'xla'`` tier's."""
    trans, inputs, targets, _, _ = _case(9, t_total=12, num_batches=4, num_labels=6,
                                         s_total=4)
    li = np.array([12, 9, 12, 7], np.int32)
    for lo, empty in ((np.array([0, 0, 2, 4], np.int32), True),
                      (np.array([5, 3, 2, 6], np.int32), False)):
        case = (trans, inputs, targets, li, lo)
        want = jx.viterbi_align(*_jax(*case), impl="xla")
        got = pt.viterbi_align(*_torch(*case), impl=impl)
        np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        outside = (lo < 1) | (lo > targets.shape[1])
        assert (got.scores.numpy()[outside] == -np.inf).all()
        assert np.isfinite(got.scores.numpy()[~outside]).all()
        if empty:
            np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
        else:
            assert np.isnan(np.asarray(want.scores)[outside]).all()
            np.testing.assert_allclose(got.scores.numpy()[~outside],
                                       np.asarray(want.scores)[~outside], rtol=1e-12)


def test_kernel_plain_versions_match_jax_kernels():
    """The plain K12 and K13 against the Pallas kernels they replace: the
    advance bits, the end rows and the positions, bit for bit."""
    trans, inputs, targets, li, lo = _case(4)
    jlat = jfac.make_aligned(*_jax(trans, inputs, targets, li, lo))
    jd, jadv = jvk.align_forward_pallas(jlat, jnp.asarray(li))
    plat = pfac.make_aligned(*_torch(trans, inputs, targets, li, lo))
    pd, padv = pvk.align_forward_plain(plat, torch.from_numpy(li))
    np.testing.assert_array_equal(padv.numpy(), np.asarray(jadv))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    end_s = (lo - 1).astype(np.int32)
    jpos = jvk.align_backtrace_pallas(jnp.asarray(end_s), jadv, jnp.asarray(li))
    ppos = pvk.align_backtrace_plain(torch.from_numpy(end_s), padv, torch.from_numpy(li))
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))


def test_wrappers_run_plain_versions_on_cpu():
    LAUNCHES.clear()
    trans, inputs, targets, li, lo = _torch(*_case(5))
    lat = pfac.make_aligned(trans, inputs, targets, li, lo)
    d_end, adv = pvk.align_forward_pallas(lat, li)
    want_d, want_adv = pvk.align_forward_plain(lat, li)
    assert torch.equal(adv, want_adv)
    torch.testing.assert_close(d_end, want_d, rtol=0, atol=0)
    end_s = (lo - 1).to(torch.int32)
    assert torch.equal(pvk.align_backtrace_pallas(end_s, adv, li),
                       pvk.align_backtrace_plain(end_s, adv, li))
    assert not LAUNCHES


def test_auto_is_xla_on_cpu_and_agrees():
    case = _torch(*_case(6))
    auto = pt.viterbi_align(*case)
    pallas = pt.viterbi_align(*case, impl="pallas")
    assert torch.equal(auto.positions, pallas.positions)
    torch.testing.assert_close(auto.scores, pallas.scores, rtol=0, atol=0)


def test_width_cap_and_impl_contract():
    s = ALIGN_KERNEL_MAX_WIDTH + 1
    args = (torch.zeros((8, 8)), torch.zeros((4, 2, 8)), torch.zeros((2, s), dtype=torch.int32))
    with pytest.raises(ValueError, match="pallas"):
        pt.viterbi_align(*args, impl="pallas")
    assert pt.viterbi_align(*args).positions.shape == (4, 2)  # 'auto' runs 'xla'
    with pytest.raises(ValueError, match="impl"):
        pt.viterbi_align(*args, impl="bogus")


def test_alignment_segments_match_jax():
    """Spans partition each utterance: slot 0 starts at 0, spans abut, the
    last used slot ends at L_in - 1, unused slots are (-1, -1)."""
    rng = np.random.default_rng(7)
    t_total, num_batches, num_labels, s_total = 14, 3, 6, 4
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    li, lo = np.array([14, 9, 5], np.int32), np.array([4, 3, 2], np.int32)
    case = (trans, inputs, targets, li, lo)
    want = jx.alignment_segments(jx.viterbi_align(*_jax(*case)), s_total)
    got = pt.alignment_segments(pt.viterbi_align(*_torch(*case)), s_total)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    starts, ends = got.starts.numpy(), got.ends.numpy()
    for b in range(num_batches):
        assert starts[b, 0] == 0 and ends[b, lo[b] - 1] == li[b] - 1
        assert (starts[b, 1:lo[b]] == ends[b, :lo[b] - 1] + 1).all()
        assert (starts[b, lo[b]:] == -1).all() and (ends[b, lo[b]:] == -1).all()


def test_half_precision_inputs_upcast():
    trans, inputs, targets, li, lo = _case(8)
    half = torch.from_numpy(inputs).to(torch.float16)
    args = _torch(targets, li, lo)
    got = pt.viterbi_align(torch.from_numpy(trans), half, *args, impl="pallas")
    want = pt.viterbi_align(torch.from_numpy(trans).float(), half.float(), *args,
                            impl="pallas")
    assert got.scores.dtype == torch.float32
    assert torch.equal(got.positions, want.positions)
