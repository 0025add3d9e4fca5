"""K10's warp route in torch (``_viterbi_forward_split_plain``: the max-plus
chain alone, then the backpointers recomputed per chunk of frames from the
chain's rows) against K10's plain version ``viterbi_forward_plain`` and
against the JAX package's Pallas Viterbi forward kernel (interpret mode),
and the rule, checks and counts of K10's two routes.

Max-plus is exact, so every comparison is bit for bit: backpointers, end
rows and backtraced paths, ties included (the lowest source label wins).
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


def _case(seed, t_total, num_batches, num_labels, kind="random", li=None, neg_inf=False,
          dtype=np.float64):
    """Seeded numpy inputs (transition, emissions, lengths).  ``kind``:
    'random' (normal), 'integer' (small integers, so exact ties are common
    at every step) or 'equal' (one emission value per frame and element,
    zero transitions: every label ties at every step); ``li`` None draws
    ragged lengths in [T/2, T]; ``neg_inf`` forbids about 30% of the
    transitions."""
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
    if li is None:
        li = rng.integers(max(1, t_total // 2), t_total + 1, size=num_batches)
    return trans.astype(dtype), inputs.astype(dtype), np.asarray(li, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _assert_same(got, want, li, label):
    """Bit-identical end rows and backpointers, and the same backtraced
    paths from the end rows' best labels."""
    assert torch.equal(got[1], want[1]), f"{label}: backpointers differ"
    assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0]), \
        f"{label}: end rows differ"
    final = pvk.argmax_first(want[0], dim=1)[1]
    assert torch.equal(pvk.viterbi_backtrace_plain(final, got[1], li),
                       pvk.viterbi_backtrace_plain(final, want[1], li)), f"{label}: paths"


@pytest.mark.parametrize("name, shape, kind, li, chunk, neg_inf", [
    ("random", (17, 5, 7), "random", None, 3, False),
    ("integer_ties", (17, 5, 7), "integer", None, 4, False),
    ("all_equal", (13, 4, 9), "equal", None, 5, False),
    ("neg_inf_transitions", (15, 4, 8), "integer", None, 2, True),
    ("lengths_0_1_t_t_plus_1", (9, 4, 6), "integer", [0, 1, 9, 10], 4, False),
    ("one_label", (8, 3, 1), "random", [8, 1, 5], 3, False),
    ("width_edge_n32", (12, 3, 32), "integer", None, None, False),
    ("width_edge_n33", (12, 3, 33), "integer", None, 5, True),
    ("width_edge_n128", (8, 2, 128), "integer", [8, 5], None, False),
    ("chunk_past_t", (6, 3, 5), "random", None, 20, False),
])
def test_split_plain_matches_forward_plain(name, shape, kind, li, chunk, neg_inf):
    trans, inputs, li = _torch(*_case(41, *shape, kind=kind, li=li, neg_inf=neg_inf))
    want = pvk.viterbi_forward_plain(trans, inputs, li)
    got = pvk._viterbi_forward_split_plain(trans, inputs, li, chunk=chunk)
    _assert_same(got, want, li, name)


def test_split_plain_matches_forward_plain_fp32_integer_ties():
    """fp32, the serving dtype, on integer emissions that force ties."""
    trans, inputs, li = _torch(*_case(43, 20, 4, 30, kind="integer", dtype=np.float32))
    want = pvk.viterbi_forward_plain(trans, inputs, li)
    got = pvk._viterbi_forward_split_plain(trans, inputs, li, chunk=6)
    _assert_same(got, want, li, "fp32 integer ties")


@pytest.mark.parametrize("kind, li, neg_inf", [
    ("random", [17, 12, 1, 9, 17], False),
    ("integer", [17, 12, 1, 9, 17], False),
    ("integer", [17, 16, 2, 9, 5], True),
])
def test_split_plain_matches_jax_kernel(kind, li, neg_inf):
    """The warp route's algorithm against the Pallas forward kernel it
    replaces: end rows and the whole backpointer tensor, bit for bit."""
    trans, inputs, li = _case(3, 17, 5, 7, kind=kind, li=li, neg_inf=neg_inf)
    jd, jbp = jvk.viterbi_forward_pallas(*[jnp.asarray(a) for a in (trans, inputs, li)])
    got = pvk._viterbi_forward_split_plain(*_torch(trans, inputs, li), chunk=4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jbp))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))


@pytest.mark.parametrize("num_labels, route", [
    (1, "warp"), (30, "warp"), (128, "warp"), (129, "block"), (1024, "block"),
])
def test_viterbi_route_rule(num_labels, route):
    assert kcommon.width_route(num_labels) == route


def _fake_launch(launched):
    """A stand-in for ``_launch_fwd`` that records the route and writes the
    route's plain version's outputs (the warp route's split algorithm, the
    block route's step-by-step loop) into the wrapper's."""

    def launch(route, trans_t, inputs, li, outs):
        launched.append(route)
        plain = (pvk._viterbi_forward_split_plain if route == "warp"
                 else pvk.viterbi_forward_plain)
        d_end, bp = plain(trans_t.t(), inputs, li)
        outs[0].copy_(bp)
        outs[1].copy_(d_end)

    return launch


def _recording_launches(monkeypatch):
    """Make every tensor of the module take the kernel path, replace K10's
    launch by ``_fake_launch``."""
    launched = []
    monkeypatch.setattr(pvk, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pvk, "_launch_fwd", _fake_launch(launched))
    return launched


def test_bad_k10_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pvk.viterbi_forward_pallas
    with pytest.raises(ValueError, match="unknown K10 route"):
        fn(*_torch(*_case(5, 6, 2, 5)), route="grid")
    with pytest.raises(ValueError, match="K10's warp route"):
        fn(*_torch(*_case(5, 6, 2, 129)), route="warp")
    assert launched == [] and not LAUNCHES


def test_k10_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the
    wrapper hands back what the launch wrote, the plain version's bits."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pvk.viterbi_forward_pallas
    narrow = _torch(*_case(7, 10, 3, 30, kind="integer"))
    wide = _torch(*_case(7, 6, 2, 130))
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K10": 3, "K10.warp": 1, "K10.block": 2}
    _assert_same(got, pvk.viterbi_forward_plain(*narrow), narrow[2], "warp dispatch")


@pytest.mark.parametrize("kind", ["random", "integer"])
def test_decode_through_the_warp_route_equals_xla(monkeypatch, kind):
    """``viterbi_decode(impl='pallas')`` at a letter width takes K10's warp
    route ('auto' at N <= 128), and its scores and paths equal the
    ``'xla'`` tier's bit for bit."""
    launched = _recording_launches(monkeypatch)
    monkeypatch.setattr(pvit, "viterbi_backtrace_pallas", pvk.viterbi_backtrace_plain)
    trans, inputs, li = _torch(*_case(9, 15, 5, 30, kind=kind, li=[15, 12, 1, 9, 15]))
    got = pt.viterbi_decode(trans, inputs, li, impl="pallas")
    want = pt.viterbi_decode(trans, inputs, li, impl="xla")
    assert launched == ["warp"]
    assert torch.equal(got.paths, want.paths)
    assert torch.equal(got.scores, want.scores)
