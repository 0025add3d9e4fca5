"""K12 (the forced-alignment forward) and its two routes: ``align_forward_plain``,
the plain version of both, against the JAX package's Pallas alignment
forward kernel (interpret mode), the contract the warp route's early stop
rests on, and the rule, checks and counts of K12's two routes.

Max-plus is exact, so every comparison is bit for bit: the advance bits in
every (t, b, s), the end rows and the backtraced positions, stay/advance
ties included (a tie stays).  Inputs are made with numpy from a seed and
run on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops import fac as jfac
from torch_asg_tpu.ops.pallas import viterbi_kernels as jvk
from torch_asg_tpu_torch.ops import fac as pfac
from torch_asg_tpu_torch.ops import viterbi as pvit
from torch_asg_tpu_torch.ops.kernels import common as kcommon
from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as pvk
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES

NUM_LABELS = 6


def _case(seed, t_total, num_batches, s_total, kind="random", li=None, lo=None,
          neg_inf=False, num_labels=NUM_LABELS, dtype=np.float64):
    """Seeded numpy inputs (transition, emissions, targets, lengths).
    ``kind``: 'random' (normal), 'integer' (small integers, so stay and
    advance tie often) or 'equal' (one emission value per frame and
    element, zero transitions: they tie at every step); ``li`` None draws
    input lengths in [T/2, T], ``lo`` None target lengths in [1, S];
    ``neg_inf`` forbids about 30% of the transitions."""
    rng = np.random.default_rng(seed)
    shape = (t_total, num_batches, num_labels)
    if kind == "integer":
        inputs = rng.integers(-2, 3, size=shape).astype(np.float64)
        trans = rng.integers(-1, 2, size=(num_labels, num_labels)).astype(np.float64)
    elif kind == "equal":
        inputs = np.tile(rng.normal(size=(t_total, num_batches, 1)), (1, 1, num_labels))
        trans = np.zeros((num_labels, num_labels))
    else:
        inputs = rng.normal(size=shape)
        trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    if neg_inf:
        trans[rng.random((num_labels, num_labels)) < 0.3] = -np.inf
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    if li is None:
        li = rng.integers(max(1, t_total // 2), t_total + 1, size=num_batches)
    if lo is None:
        lo = rng.integers(1, s_total + 1, size=num_batches)
    return (trans.astype(dtype), inputs.astype(dtype), targets, np.asarray(li, np.int32),
            np.asarray(lo, np.int32))


def _port(trans, inputs, targets, li, lo):
    """K12's arguments in the port: the aligned lattice and the input lengths."""
    trans, inputs, targets, li, lo = map(torch.from_numpy, (trans, inputs, targets, li, lo))
    return pfac.make_aligned(trans, inputs, targets, li, lo), li


CASES = [
    ("random", (17, 5, 7), "random", None, None, False),
    ("integer_ties", (17, 5, 7), "integer", None, None, False),
    ("all_equal", (13, 4, 5), "equal", None, None, False),
    ("neg_inf_transitions", (15, 4, 8), "integer", None, None, True),
    ("lengths_0_1_t_t_plus_1", (9, 5, 6), "integer", [0, 1, 9, 10, 4], [2, 3, 6, 4, 6],
     False),
    ("l_in_1", (8, 3, 4), "random", [1, 1, 8], [1, 3, 4], False),
    ("width_edge_s32", (10, 3, 32), "integer", None, None, False),
    ("width_edge_s33", (10, 3, 33), "integer", [10, 7, 10], [33, 20, 5], True),
    ("width_edge_s64", (9, 2, 64), "integer", None, None, False),
    ("width_edge_s65", (9, 2, 65), "random", [9, 6], [65, 40], False),
    ("width_edge_s128", (8, 2, 128), "integer", [8, 5], [128, 3], False),
]


@pytest.mark.parametrize("name, shape, kind, li, lo, neg_inf", CASES)
def test_plain_matches_jax_kernel(name, shape, kind, li, lo, neg_inf):
    """The plain version of both routes against the Pallas kernel it
    replaces: every advance bit and the end rows, bit for bit, and the
    positions backtraced from them where L_in lies in [1, T] (past T the
    Pallas backtrace starts inside its padded frames; the port's positions
    there equal the JAX ``'xla'`` tier's)."""
    case = _case(11, *shape, kind=kind, li=li, lo=lo, neg_inf=neg_inf)
    trans, inputs, targets, li, lo = case
    jlat = jfac.make_aligned(*[jnp.asarray(a) for a in case])
    jd, jadv = jvk.align_forward_pallas(jlat, jnp.asarray(li))
    d_end, adv = pvk.align_forward_plain(*_port(*case))
    np.testing.assert_array_equal(adv.numpy(), np.asarray(jadv), err_msg=f"{name}: bits")
    np.testing.assert_array_equal(d_end.numpy(), np.asarray(jd), err_msg=f"{name}: end rows")
    end_s = (lo - 1).astype(np.int32)
    jpos = jvk.align_backtrace_pallas(jnp.asarray(end_s), jadv, jnp.asarray(li))
    pos = pvk.align_backtrace_plain(torch.from_numpy(end_s), adv, torch.from_numpy(li))
    inside = li <= shape[0]
    np.testing.assert_array_equal(pos.numpy()[:, inside], np.asarray(jpos)[:, inside],
                                  err_msg=f"{name}: positions")


@pytest.mark.parametrize("name, shape, kind, li, lo, neg_inf", CASES)
def test_bits_past_row_l_in_are_zero(name, shape, kind, li, lo, neg_inf):
    """The warp route walks each element's chain to row min(L_in, T - 1) and
    writes zeros past it: the plain version's bits are 0 in row 0 and in
    every row past L_in, because ``make_aligned``'s emissions are -inf from
    frame L_in on; the end row is -inf where L_in lies outside [1, T]."""
    case = _case(11, *shape, kind=kind, li=li, lo=lo, neg_inf=neg_inf)
    t_total = shape[0]
    d_end, adv = pvk.align_forward_plain(*_port(*case))
    li = case[3]
    rows = np.arange(t_total)[:, None]
    past = (rows > np.maximum(li, 0)[None, :]) | (rows == 0)
    assert (adv.numpy()[past] == 0).all(), f"{name}: a bit past row L_in"
    outside = (li < 1) | (li > t_total)
    assert (d_end.numpy()[outside] == -np.inf).all()


def test_row_l_in_can_advance():
    """Row L_in (when L_in < T) reads d_{L_in - 1}, so the warp route walks
    it: at L_in = 1 with two targets, slot 1 of row 1 advances from slot 0."""
    case = _case(12, 6, 2, 3, li=[1, 6], lo=[2, 3])
    _, adv = pvk.align_forward_plain(*_port(*case))
    assert adv[1, 0, 1] == 1 and (adv[2:, 0] == 0).all()


@pytest.mark.parametrize("s_total, route", [
    (1, "warp"), (50, "warp"), (128, "warp"), (129, "block"), (512, "block"),
])
def test_k12_route_rule(s_total, route):
    assert kcommon.width_route(s_total) == route


def _recording_launches(monkeypatch):
    """Make every tensor of the module take the kernel path, replace K12's
    launch by one that records its route and copies ``align_forward_plain``'s
    outputs into the wrapper's."""
    launched = []

    def launch(route, lat, li, outs):
        launched.append(route)
        d_end, adv = pvk.align_forward_plain(lat, li)
        outs[0].copy_(adv)
        outs[1].copy_(d_end)

    monkeypatch.setattr(pvk, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pvk, "_launch_align", launch)
    return launched


def test_bad_k12_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pvk.align_forward_pallas
    with pytest.raises(ValueError, match="unknown K12 route"):
        fn(*_port(*_case(5, 6, 2, 5)), route="grid")
    with pytest.raises(ValueError, match="K12's warp route"):
        fn(*_port(*_case(5, 6, 2, 129)), route="warp")
    assert launched == [] and not LAUNCHES


def test_k12_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the
    wrapper hands back what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pvk.align_forward_pallas
    narrow = _port(*_case(7, 10, 3, 50, kind="integer"))
    wide = _port(*_case(7, 6, 2, 130))
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K12": 3, "K12.warp": 1, "K12.block": 2}
    want = pvk.align_forward_plain(*narrow)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["random", "integer"])
def test_align_through_the_warp_route_equals_xla(monkeypatch, kind):
    """``viterbi_align(impl='pallas')`` at a letter width (N = 30, S = 50)
    takes K12's warp route, and its scores, positions and labels equal the
    ``'xla'`` tier's bit for bit, the empty transcript's -inf included."""
    launched = _recording_launches(monkeypatch)
    monkeypatch.setattr(pvit, "align_backtrace_pallas", pvk.align_backtrace_plain)
    trans, inputs, targets, li, lo = _case(9, 60, 4, 50, kind=kind, li=[60, 45, 1, 52],
                                           lo=[50, 7, 1, 0], num_labels=30)
    args = [torch.from_numpy(a) for a in (trans, inputs, targets, li, lo)]
    got = pt.viterbi_align(*args, impl="pallas")
    want = pt.viterbi_align(*args, impl="xla")
    assert launched == ["warp"]
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.scores, want.scores) and got.scores[3] == -np.inf
