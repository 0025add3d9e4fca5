"""K11 (the 1-best backtrace) and its two routes: ``viterbi_backtrace_plain``,
the plain version of both, against the JAX package's Pallas backtrace kernel
(interpret mode) and against the rule written out in numpy, and the rule,
checks and counts of K11's two routes.

The backtrace is integer work, so every comparison is bit for bit.  The
backpointers are drawn at random, inside [0, N) and outside it, and the
final labels lie inside and outside [0, N): frame L_in - 1 holds the final
label as given, and a label outside [0, N) reads 0 at the frame before it
(a negative one reads column 0).  Inputs are made with numpy from a seed and
run on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops.pallas import viterbi_kernels as jvk
from torch_asg_tpu_torch.ops import viterbi as pvit
from torch_asg_tpu_torch.ops.kernels import common as kcommon
from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as pvk
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES


def _case(seed, t_total, num_labels, li, final, wild=False):
    """Seeded (backptr (T, B, N), final labels (B,), input lengths (B,)) as
    int32 numpy arrays; ``wild`` draws backpointers in [-3, N + 3) in place
    of [0, N)."""
    rng = np.random.default_rng(seed)
    lo, hi = (-3, num_labels + 3) if wild else (0, num_labels)
    bp = rng.integers(lo, hi, size=(t_total, len(li), num_labels)).astype(np.int32)
    return bp, np.asarray(final, np.int32), np.asarray(li, np.int32)


def _rule(bp, final, li):
    """The backtrace's rule, element by element: -1 from frame L_in on (from
    T - 1 when L_in > T), the final label at L_in - 1, and before it
    bp[t + 1][max(x, 0)], or 0 where max(x, 0) >= N."""
    t_total, num_batches, num_labels = bp.shape
    out = np.full((t_total, num_batches), -1, np.int32)
    for b in range(num_batches):
        x = int(final[b]) if 1 <= li[b] <= t_total else -1
        live = min(max(int(li[b]), 0), t_total)
        if live:
            out[live - 1, b] = x
        for t in range(live - 2, -1, -1):
            s = max(x, 0)
            x = int(bp[t + 1, b, s]) if s < num_labels else 0
            out[t, b] = x
    return out


def _plain(bp, final, li):
    return pvk.viterbi_backtrace_plain(*map(torch.from_numpy, (final, bp, li))).numpy()


# (name, T, N, L_in, final labels, wild backpointers): widths 1, 5, 31, 32,
# 33 and 65; lengths in [0, T]; final labels -1, 0, N - 1, N, N + 2, N + 5.
CASES = [
    ("probe_t9_n5", 9, 5, [9, 9, 5, 9], [7, -1, 2, 4], False),
    ("width_1", 12, 1, [12, 7, 1, 12, 0], [0, -1, 0, 1, 3], False),
    ("width_5", 14, 5, [14, 13, 6, 1, 14, 9], [-1, 0, 4, 5, 7, 10], False),
    ("width_5_wild", 14, 5, [14, 13, 6, 1, 14, 9], [-1, 0, 4, 5, 7, 10], True),
    ("width_31", 11, 31, [11, 10, 3, 11], [30, 31, 33, -1], False),
    ("width_32", 11, 32, [11, 5, 11, 2], [31, 32, 0, 37], True),
    ("width_33", 10, 33, [10, 9, 10, 4], [32, 33, 35, -1], False),
    ("width_65", 10, 65, [10, 1, 10, 7], [64, 65, 67, 0], True),
]


@pytest.mark.parametrize("name, t_total, num_labels, li, final, wild", CASES)
def test_plain_matches_jax_kernel(name, t_total, num_labels, li, final, wild):
    """The plain version of both routes against the Pallas kernel it
    replaces, bit for bit, final labels outside [0, N) included (the
    kernel's one-hot select reads 0 past N)."""
    bp, final, li = _case(3, t_total, num_labels, li, final, wild)
    want = jvk.viterbi_backtrace_pallas(jnp.asarray(final), jnp.asarray(bp), jnp.asarray(li))
    np.testing.assert_array_equal(_plain(bp, final, li), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("num_labels", [1, 5, 33])
def test_plain_follows_the_rule(num_labels, wild):
    """Every input length the kernel may meet, 0 and past T included (a
    walk from -1 at frame T - 1, which reads column 0), against the rule
    written out in numpy."""
    t_total = 8
    li = [-1, 0, 1, 2, 7, 8, 9, 12]
    final = [num_labels + 2, -1, 0, num_labels - 1, num_labels, 3, -1, 1]
    bp, final, li = _case(4, t_total, num_labels, li, final, wild)
    np.testing.assert_array_equal(_plain(bp, final, li), _rule(bp, final, li))


def test_repair_final_labels_outside_the_range():
    """Final labels N + 2 and -1 are written as given at frame L_in - 1, and
    the frame before reads 0 and column 0, not what a clamp into [0, N - 1]
    would give."""
    bp, final, li = _case(5, 6, 4, [6, 6], [6, -1])
    got = _plain(bp, final, li)
    assert got[5, 0] == 6 and got[4, 0] == 0 and got[3, 0] == bp[4, 0, 0]
    assert got[5, 1] == -1 and got[4, 1] == bp[5, 1, 0]


@pytest.mark.parametrize("num_labels, route", [
    (1, "warp"), (30, "warp"), (128, "warp"), (129, "block"), (1024, "block"),
])
def test_k11_route_rule(num_labels, route):
    assert kcommon.width_route(num_labels) == route


def _recording_launches(monkeypatch):
    """Make every tensor of the module take the kernel path, replace the
    backtraces' launch by one that records its kernel and route and copies
    the plain version's output into the wrapper's."""
    launched = []

    def launch(stem, route, rows, start, li, out):
        launched.append((stem, route))
        plain = (pvk.viterbi_backtrace_plain if stem == "viterbi_backtrace"
                 else pvk.align_backtrace_plain)
        out.copy_(plain(start, rows, li))

    monkeypatch.setattr(pvk, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pvk, "_launch_backtrace", launch)
    return launched


def _tensors(bp, final, li):
    return torch.from_numpy(final), torch.from_numpy(bp), torch.from_numpy(li)


def test_bad_k11_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pvk.viterbi_backtrace_pallas
    with pytest.raises(ValueError, match="unknown K11 route"):
        fn(*_tensors(*_case(6, 6, 5, [6, 3], [1, 2])), route="grid")
    with pytest.raises(ValueError, match="K11's warp route"):
        fn(*_tensors(*_case(6, 6, 129, [6, 3], [1, 2])), route="warp")
    assert launched == [] and not LAUNCHES


def test_k11_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the
    wrapper hands back what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pvk.viterbi_backtrace_pallas
    narrow = _tensors(*_case(7, 10, 30, [10, 4, 9], [3, 31, -1]))
    wide = _tensors(*_case(7, 6, 130, [6, 2], [0, 129]))
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == [("viterbi_backtrace", r) for r in ("warp", "block", "block")]
    assert LAUNCHES == {"K11": 3, "K11.warp": 1, "K11.block": 2}
    assert torch.equal(got, pvk.viterbi_backtrace_plain(*narrow))


@pytest.mark.parametrize("integer", [False, True])
def test_decode_through_the_warp_route_equals_xla(monkeypatch, integer):
    """``viterbi_decode(impl='pallas')`` at the letter width (N = 30) takes
    K11's warp route, and its paths and scores equal the ``'xla'`` tier's
    bit for bit, ties included."""
    launched = _recording_launches(monkeypatch)
    monkeypatch.setattr(pvit, "viterbi_forward_pallas", pvk.viterbi_forward_plain)
    rng = np.random.default_rng(8)
    shape = (40, 4, 30)
    if integer:
        inputs = rng.integers(-2, 3, size=shape).astype(np.float64)
        trans = rng.integers(-1, 2, size=(30, 30)).astype(np.float64)
    else:
        inputs, trans = rng.normal(size=shape), rng.normal(size=(30, 30)) * 0.5
    args = [torch.from_numpy(a) for a in (trans, inputs, np.array([40, 27, 1, 39], np.int32))]
    got = pt.viterbi_decode(*args, impl="pallas")
    want = pt.viterbi_decode(*args, impl="xla")
    assert launched == [("viterbi_backtrace", "warp")]
    assert torch.equal(got.paths, want.paths)
    assert torch.equal(got.scores, want.scores)
