"""K13 (the forced-alignment backtrace) and its two routes:
``align_backtrace_plain``, the plain version of both, against the JAX
package's Pallas alignment backtrace (interpret mode) and against the rule
written out in numpy, and the rule, checks and counts of K13's two routes.

The backtrace is integer work, so every comparison is bit for bit.  The
advance rows are drawn at random, as bits in {0, 1} and as values outside
them (subtracted as given), and the end slots lie inside and outside [0, S):
frame L_in - 1 holds the end slot as given, and a position p reads
adv[t + 1][max(p, 0)], or takes no step back where that slot is S or more.
Inputs are made with numpy from a seed and run on CPU tensors.
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


def _case(seed, t_total, s_total, li, end_s, wild=False):
    """Seeded (adv (T, B, S), end slots (B,), input lengths (B,)) as int32
    numpy arrays; ``wild`` draws advance values in [-1, 3) in place of
    bits."""
    rng = np.random.default_rng(seed)
    lo, hi = (-1, 3) if wild else (0, 2)
    adv = rng.integers(lo, hi, size=(t_total, len(li), s_total)).astype(np.int32)
    return adv, np.asarray(end_s, np.int32), np.asarray(li, np.int32)


def _rule(adv, end_s, li):
    """The backtrace's rule, element by element: -1 from frame L_in on (from
    T - 1 when L_in > T), the end slot at L_in - 1, and before it p -
    adv[t + 1][p] with p = max(x, 0), or p where p >= S."""
    t_total, num_batches, s_total = adv.shape
    out = np.full((t_total, num_batches), -1, np.int32)
    for b in range(num_batches):
        x = int(end_s[b]) if 1 <= li[b] <= t_total else -1
        live = min(max(int(li[b]), 0), t_total)
        if live:
            out[live - 1, b] = x
        for t in range(live - 2, -1, -1):
            p = max(x, 0)
            x = p - int(adv[t + 1, b, p]) if p < s_total else p
            out[t, b] = x
    return out


def _plain(adv, end_s, li):
    return pvk.align_backtrace_plain(*map(torch.from_numpy, (end_s, adv, li))).numpy()


# (name, T, S, L_in, end slots, wild values): widths 1, 5, 31, 32, 33 and
# 65; lengths in [0, T]; end slots -1, 0, S - 1, S and S + 3.
CASES = [
    ("width_1", 12, 1, [12, 7, 1, 12, 0], [0, -1, 0, 1, 4], False),
    ("width_5", 14, 5, [14, 13, 6, 1, 14, 9], [-1, 0, 4, 5, 8, 2], False),
    ("width_5_wild", 14, 5, [14, 13, 6, 1, 14, 9], [-1, 0, 4, 5, 8, 2], True),
    ("width_31", 11, 31, [11, 10, 3, 11], [30, 31, 34, -1], False),
    ("width_32", 11, 32, [11, 5, 11, 2], [31, 32, 0, 35], True),
    ("width_33", 40, 33, [40, 39, 40, 4], [32, 33, 36, -1], False),
    ("width_65", 10, 65, [10, 1, 10, 7], [64, 65, 68, 0], True),
]


@pytest.mark.parametrize("name, t_total, s_total, li, end_s, wild", CASES)
def test_plain_matches_jax_kernel(name, t_total, s_total, li, end_s, wild):
    """The plain version of both routes against the Pallas kernel it
    replaces, bit for bit, on random rows, with end slots outside [0, S)
    and advance values other than 0 and 1 subtracted as given."""
    adv, end_s, li = _case(3, t_total, s_total, li, end_s, wild)
    want = jvk.align_backtrace_pallas(jnp.asarray(end_s), jnp.asarray(adv), jnp.asarray(li))
    np.testing.assert_array_equal(_plain(adv, end_s, li), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("s_total", [1, 5, 33])
def test_plain_follows_the_rule(s_total, wild):
    """Every input length the kernel may meet, 0 and past T included (a
    walk from -1 at frame T - 1, which reads slot 0), against the rule
    written out in numpy."""
    t_total = 8
    li = [-1, 0, 1, 2, 7, 8, 9, 12]
    end_s = [s_total + 3, -1, 0, s_total - 1, s_total, 2, -1, 1]
    adv, end_s, li = _case(4, t_total, s_total, li, end_s, wild)
    np.testing.assert_array_equal(_plain(adv, end_s, li), _rule(adv, end_s, li))


@pytest.mark.parametrize("s_total, route", [
    (1, "warp"), (50, "warp"), (128, "warp"), (129, "block"), (512, "block"),
])
def test_k13_route_rule(s_total, route):
    assert kcommon.width_route(s_total) == route


def _recording_launches(monkeypatch):
    """Make every tensor of the module take the kernel path, replace the
    backtraces' launch by one that records its kernel and route and copies
    the plain version's output into the wrapper's."""
    launched = []

    def launch(stem, route, rows, start, li, out):
        launched.append((stem, route))
        plain = (pvk.align_backtrace_plain if stem == "align_backtrace"
                 else pvk.viterbi_backtrace_plain)
        out.copy_(plain(start, rows, li))

    monkeypatch.setattr(pvk, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pvk, "_launch_backtrace", launch)
    return launched


def _tensors(adv, end_s, li):
    return torch.from_numpy(end_s), torch.from_numpy(adv), torch.from_numpy(li)


def test_bad_k13_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pvk.align_backtrace_pallas
    with pytest.raises(ValueError, match="unknown K13 route"):
        fn(*_tensors(*_case(6, 6, 5, [6, 3], [1, 2])), route="grid")
    with pytest.raises(ValueError, match="K13's warp route"):
        fn(*_tensors(*_case(6, 6, 129, [6, 3], [1, 2])), route="warp")
    assert launched == [] and not LAUNCHES


def test_k13_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the
    wrapper hands back what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pvk.align_backtrace_pallas
    narrow = _tensors(*_case(7, 10, 50, [10, 4, 9], [3, 53, -1]))
    wide = _tensors(*_case(7, 6, 130, [6, 2], [0, 129]))
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == [("align_backtrace", r) for r in ("warp", "block", "block")]
    assert LAUNCHES == {"K13": 3, "K13.warp": 1, "K13.block": 2}
    assert torch.equal(got, pvk.align_backtrace_plain(*narrow))


@pytest.mark.parametrize("kind", ["random", "integer"])
def test_align_through_the_warp_route_equals_xla(monkeypatch, kind):
    """``viterbi_align(impl='pallas')`` at the letter width (N = 30, S = 50)
    takes K13's warp route, and its positions and labels equal the
    ``'xla'`` tier's bit for bit, the empty transcript's included."""
    launched = _recording_launches(monkeypatch)
    monkeypatch.setattr(pvit, "align_forward_pallas", pvk.align_forward_plain)
    rng = np.random.default_rng(9)
    shape = (60, 4, 30)
    if kind == "integer":
        inputs = rng.integers(-2, 3, size=shape).astype(np.float64)
        trans = rng.integers(-1, 2, size=(30, 30)).astype(np.float64)
    else:
        inputs, trans = rng.normal(size=shape), rng.normal(size=(30, 30)) * 0.5
    targets = rng.integers(0, 30, size=(4, 50)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (trans, inputs, targets,
                                          np.array([60, 45, 1, 52], np.int32),
                                          np.array([50, 7, 1, 0], np.int32))]
    got = pt.viterbi_align(*args, impl="pallas")
    want = pt.viterbi_align(*args, impl="xla")
    assert launched == [("align_backtrace", "warp")]
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.scores, want.scores) and got.scores[3] == -np.inf
