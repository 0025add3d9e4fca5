"""K6 (the FAC alpha chain) and its two routes: ``fac_alpha_blocked_plain``,
the plain version of the warp route (bands over blocks of k frames, a
chain over the checkpoint rows by a (k+1)-term log-sum-exp, the rows
between them filled in), against the JAX package's Pallas FAC alpha kernel
(interpret mode) for k = 1, 2, 4 and 8, on ragged and degenerate lengths,
-inf transitions, T = 1, T < k, T - 1 not a multiple of k and the warp
route's width edges; and the rule, checks and counts of K6's two routes on
every caller of the per-lattice tier.

Inputs are made with numpy from a seed; everything runs at fp64 on CPU
tensors.  Tolerance: rtol 1e-9 and atol 1e-12 x the output's largest
finite magnitude; the -inf entries must match exactly and no NaN may
appear.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops.pallas import fac_kernels as jfac
from torch_asg_tpu_torch.ops.fac import make_aligned
from torch_asg_tpu_torch.ops.kernels import common as kcommon
from torch_asg_tpu_torch.ops.kernels import fac_kernels as pfac
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES

RTOL, ATOL_REL = 1e-9, 1e-12
NUM_LABELS = 6

# (T, B, S), input lengths, target lengths (None: drawn), -inf transitions
CASES = {
    "ragged": ((11, 3, 5), None, None, False),
    "lengths_0_1_t_t_plus_1": ((8, 5, 5), [0, 1, 8, 9, 8], [1, 1, 5, 3, 2], False),
    "target_longer_than_input": ((6, 3, 9), [3, 6, 6], [5, 9, 6], False),
    "neg_inf_transitions": ((13, 4, 7), None, None, True),
    "t_1": ((1, 3, 4), [1, 1, 0], [1, 4, 2], False),
    "t_below_k": ((3, 2, 4), [3, 2], [2, 4], False),
    "t_minus_1_not_a_multiple": ((10, 3, 6), None, None, True),
    "width_edge_s32": ((9, 2, 32), [9, 7], [32, 20], False),
    "width_edge_s33": ((9, 2, 33), [9, 9], [33, 17], True),
    "width_edge_s64": ((7, 2, 64), [7, 7], [64, 40], False),
    "width_edge_s65": ((7, 2, 65), [7, 6], [65, 30], False),
    "width_edge_s128": ((6, 2, 128), [6, 6], [128, 90], False),
}


def _case(seed, t_total, num_batches, s_total, li=None, lo=None, neg_inf=False,
          num_labels=NUM_LABELS):
    """Seeded numpy inputs (transition, emissions, targets, lengths); ``li``
    None draws input lengths in [T/2, T], ``lo`` None target lengths in
    [1, S]; ``neg_inf`` forbids about 30% of the transitions."""
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    if neg_inf:
        trans[rng.random((num_labels, num_labels)) < 0.3] = -np.inf
    targets = rng.integers(0, num_labels, size=(num_batches, s_total))
    if li is None:
        li = rng.integers(max(1, t_total // 2), t_total + 1, size=num_batches)
    if lo is None:
        lo = rng.integers(1, s_total + 1, size=num_batches)
    return (trans, inputs, targets.astype(np.int32), np.asarray(li, np.int32),
            np.asarray(lo, np.int32))


def _lattice(trans, inputs, targets, li, lo):
    return make_aligned(*map(torch.from_numpy, (trans, inputs, targets, li, lo)))


@functools.cache
def _want(name):
    """(the case's numpy inputs, the JAX Pallas FAC alpha kernel's output cut
    to (T, B, S)), once a case."""
    (t_total, num_batches, s_total), li, lo, neg_inf = CASES[name]
    case = _case(29, t_total, num_batches, s_total, li, lo, neg_inf)
    _, ali_p, self_t, next_t, _, _, _ = jfac._prepare(*[jnp.asarray(a) for a in case])
    alpha = np.asarray(jfac._fac_alpha_pass(self_t, next_t, ali_p))
    return case, alpha[:, :num_batches, :s_total]


def _assert_near(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    assert not np.isnan(got).any(), f"{label}: NaN"
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=f"{label}: finite entries")
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=f"{label}: infinities")
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30), err_msg=label)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_blocked_plain_matches_jax_kernel(k, name):
    """The warp route's algorithm at k frames a block against the Pallas FAC
    alpha kernel it replaces, -inf rows and slots included (rows t >= L_in,
    slots s >= L_out, every row when L_in is outside [1, T])."""
    case, want = _want(name)
    got = pfac.fac_alpha_blocked_plain(_lattice(*case), k)
    _assert_near(got.numpy(), want, f"{name} k={k}")
    t_total = want.shape[0]
    rows = np.arange(t_total)[:, None]
    assert (got.numpy()[rows >= case[3][None, :]] == -np.inf).all(), f"{name}: rows t >= L"


@pytest.mark.parametrize("name", ["ragged", "lengths_0_1_t_t_plus_1"])
def test_block_route_plain_matches_jax_kernel(name):
    """``fac_alpha_plain``, the block route's plain version, on the same
    cases: the two plain versions hold one reference."""
    case, want = _want(name)
    _assert_near(pfac.fac_alpha_plain(_lattice(*case)).numpy(), want, name)


def test_bands_count_every_path():
    """The bands of one block against a brute-force sum over its paths: W[s,
    i] is the log-sum over the paths from slot s-i at frame t0 to slot s at
    frame t0 + steps with i advances, of every transition and emission
    after t0."""
    case = _case(31, 9, 1, 5, li=[9], lo=[5])
    lat = _lattice(*case)
    k = 4
    w, steps = pfac._fac_alpha_bands(lat, k)
    assert steps.tolist() == [4, 4]
    a = lat.inputs[:, 0].numpy()
    self_t, next_t = lat.self_trans[0].numpy(), lat.next_trans[0].numpy()
    for j in range(2):
        t0 = j * k
        for s in range(5):
            for i in range(k + 1):
                if s - i < 0:
                    assert w[j, 0, i, s] == -np.inf
                    continue
                total = []
                for moves in map(list, np.ndindex(*(2,) * k)):
                    if sum(moves) != i:
                        continue
                    slot, score = s - i, 0.0
                    for m, move in enumerate(moves, start=1):
                        score += next_t[slot] if move else self_t[slot]
                        slot += move
                        score += a[t0 + m, slot]
                    total.append(score)
                np.testing.assert_allclose(float(w[j, 0, i, s]), np.logaddexp.reduce(total),
                                           rtol=1e-12)


@pytest.mark.parametrize("s_total, route", [
    (1, "warp"), (50, "warp"), (128, "warp"), (129, "block"), (512, "block"),
])
def test_k6_route_rule(s_total, route):
    assert kcommon.width_route(s_total) == route


def test_block_sizes():
    """The wrapper sizes the bands' scratch by the block size and spare
    blocks that ``csrc/fac.cu`` is built with, and the block size is one of
    the swept 2, 4 and 8."""
    src = (Path(pfac.__file__).parent / "csrc" / "fac.cu").read_text()
    for name, value in (("kAlphaBlock", pfac.FAC_ALPHA_BLOCK),
                        ("kBandSpare", pfac._BAND_SPARE)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name
    assert pfac.FAC_ALPHA_BLOCK in (2, 4, 8)


def _recording_launches(monkeypatch):
    """Make every tensor of the FAC module take the kernel path, replace
    K6's launch by one that records its route and writes the route's plain
    version's output (the blocked algorithm at the wrapper's block size for
    the warp route) into the wrapper's."""
    launched = []

    def launch(route, lat, alpha):
        launched.append(route)
        if route == "warp":
            want = pfac.fac_alpha_blocked_plain(lat, pfac.FAC_ALPHA_BLOCK)
        else:
            want = pfac.fac_alpha_plain(lat)
        alpha.copy_(want)

    monkeypatch.setattr(pfac, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pfac, "_launch_alpha", launch)
    return launched


def test_bad_k6_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfac.fac_alpha_pallas
    with pytest.raises(ValueError, match="unknown K6 route"):
        fn(_lattice(*_case(13, 6, 2, 5)), route="grid")
    with pytest.raises(ValueError, match="K6's warp route"):
        fn(_lattice(*_case(13, 6, 2, 129)), route="warp")
    assert launched == [] and not LAUNCHES


def test_k6_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the
    wrapper hands back what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfac.fac_alpha_pallas
    narrow, wide = _lattice(*_case(13, 9, 2, 50)), _lattice(*_case(13, 6, 2, 130))
    got = fn(narrow)
    fn(wide)
    fn(narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K6": 3, "K6.warp": 1, "K6.block": 2}
    assert torch.equal(got, pfac.fac_alpha_blocked_plain(narrow, pfac.FAC_ALPHA_BLOCK))


def test_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors the wrapper runs ``fac_alpha_plain`` and launches
    nothing, on either route."""
    LAUNCHES.clear()
    lat = _lattice(*_case(17, 12, 3, 7))
    fn = pfac.fac_alpha_pallas
    want = pfac.fac_alpha_plain(lat)
    for route in (None, "warp", "block"):
        assert torch.equal(fn(lat, route=route), want)
    assert not LAUNCHES


def test_training_call_takes_the_warp_route_for_k6(monkeypatch):
    """A differentiated ``impl='pallas'`` call at a letter width (N = 30, S =
    50) launches K6 once, on the warp route, and never on a score-only
    call; K7 and K8 run their plain versions, and the gradients are
    finite."""
    launched = _recording_launches(monkeypatch)
    monkeypatch.setattr(pfac, "fac_beta_pallas", lambda lat, li, lo: pfac.fac_beta_plain(
        lat, li, lo))
    monkeypatch.setattr(pfac, "fac_bwd_pallas",
                        lambda lat, alpha, beta, g: pfac.fac_bwd_plain(lat, alpha, beta, g))
    trans, inputs, targets, li, lo = _case(23, 60, 2, 50, li=[41, 60], lo=[38, 7],
                                           num_labels=30)
    trans, inputs, targets, li, lo = map(torch.from_numpy, (trans, inputs, targets, li, lo))
    with torch.no_grad():
        pt.asg_scores(trans, inputs, targets, li, lo, impl="pallas")
    assert launched == []
    em = inputs.clone().requires_grad_(True)
    loss = pt.asg_loss(trans, em, targets, li, lo, impl="pallas")
    loss.backward()
    assert launched == ["warp"]
    assert torch.isfinite(em.grad).all()
