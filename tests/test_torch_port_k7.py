"""K7 (the FAC beta chain) and its two routes: ``fac_beta_plain``, the plain
version of both (the warp route walks the same log-domain recursion on one
warp per element), against the JAX package's Pallas FAC beta kernel
(interpret mode) on ragged and degenerate lengths, and the rule, checks
and counts of K7's two routes on every caller of the per-lattice tier.

Inputs are made with numpy from a seed; everything runs at fp64 on CPU
tensors.  Tolerance: rtol 1e-9 and atol 1e-12 x the output's largest
finite magnitude; the -inf entries must match exactly.
"""

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


def _case(seed, t_total, num_batches, s_total, li=None, lo=None, num_labels=NUM_LABELS):
    """Seeded numpy inputs (transition, emissions, targets, lengths); ``li``
    None draws ragged input lengths in [T/2, T], ``lo`` None target lengths
    in [1, S]."""
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total))
    if li is None:
        li = rng.integers(max(1, t_total // 2), t_total + 1, size=num_batches)
    if lo is None:
        lo = rng.integers(1, s_total + 1, size=num_batches)
    return (trans, inputs, targets.astype(np.int32), np.asarray(li, np.int32),
            np.asarray(lo, np.int32))


def _port_args(trans, inputs, targets, li, lo):
    """K7's arguments in the port: the aligned lattice and the lengths."""
    trans, inputs, targets, li, lo = map(torch.from_numpy, (trans, inputs, targets, li, lo))
    return make_aligned(trans, inputs, targets, li, lo), li, lo


def _assert_near(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=f"{label}: finite entries")
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=f"{label}: infinities")
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30), err_msg=label)


@pytest.mark.parametrize("name, shape, li, lo", [
    ("ragged", (11, 3, 5), None, None),
    ("lengths_0_1_t_t_plus_1", (8, 5, 5), [0, 1, 8, 9, 8], [1, 1, 5, 3, 2]),
    ("target_longer_than_input", (6, 3, 9), [3, 6, 6], [5, 9, 6]),
    ("width_edge", (7, 2, 33), [7, 5], [33, 20]),
])
def test_beta_plain_matches_jax_kernel(name, shape, li, lo):
    """The plain version of both routes against the Pallas FAC beta kernel
    they replace, -inf rows included: t >= L, every row when L is outside
    [1, T], and beta_0[0] = -inf where L_out > L_in leaves no aligned
    path."""
    t_total, num_batches, s_total = shape
    trans, inputs, targets, li, lo = _case(37, t_total, num_batches, s_total, li, lo)
    _, ali_p, self_t, next_t, li_c, lo_c, _ = jfac._prepare(
        *[jnp.asarray(a) for a in (trans, inputs, targets, li, lo)])
    want = np.asarray(jfac._fac_beta_pass(li_c, lo_c, self_t, next_t, ali_p))
    got = pfac.fac_beta_plain(*_port_args(trans, inputs, targets, li, lo))
    assert not torch.isnan(got).any(), f"{name}: NaN"
    _assert_near(got.numpy(), want[:, :num_batches, :s_total], name)
    rows = np.arange(t_total)[:, None]
    assert (got.numpy()[rows >= li[None, :]] == -np.inf).all(), f"{name}: rows t >= L"
    if name == "lengths_0_1_t_t_plus_1":
        assert (got[:, [0, 3]] == -np.inf).all()
    if name == "target_longer_than_input":
        assert (got[0, :2, 0] == -np.inf).all() and torch.isfinite(got[0, 2, 0])


@pytest.mark.parametrize("s_total, route", [
    (1, "warp"), (128, "warp"), (129, "block"), (512, "block"),
])
def test_k7_route_rule(s_total, route):
    assert kcommon.width_route(s_total) == route


def _recording_launches(monkeypatch):
    """Make every tensor of the FAC module take the kernel path, replace
    K7's launch by one that records its route and copies ``fac_beta_plain``'s
    output into the wrapper's."""
    launched = []

    def launch(route, lat, li, lo, beta):
        launched.append(route)
        beta.copy_(pfac.fac_beta_plain(lat, li, lo))

    monkeypatch.setattr(pfac, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pfac, "_launch_beta", launch)
    return launched


def _k7_args(s_total, seed=13):
    return _port_args(*_case(seed, 6, 2, s_total))


def test_bad_k7_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfac.fac_beta_pallas
    with pytest.raises(ValueError, match="unknown K7 route"):
        fn(*_k7_args(5), route="grid")
    with pytest.raises(ValueError, match="K7's warp route"):
        fn(*_k7_args(129), route="warp")
    assert launched == [] and not LAUNCHES


def test_k7_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the
    wrapper hands back what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfac.fac_beta_pallas
    narrow, wide = _k7_args(50), _k7_args(130)
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K7": 3, "K7.warp": 1, "K7.block": 2}
    assert torch.equal(got, pfac.fac_beta_plain(*narrow))


def _letter_call(seed=23):
    """Letter-width inputs (N = 30 labels, S = 50 target slots, T = 60
    frames: the front-end cuts S to T), fp64; element 0 has 50 targets in
    41 frames, so no aligned path."""
    trans, inputs, targets, li, lo = _case(seed, 60, 2, 50, li=[41, 60], lo=[50, 7],
                                           num_labels=30)
    return (torch.tensor(trans), torch.tensor(inputs), torch.from_numpy(targets),
            torch.from_numpy(li), torch.from_numpy(lo))


@pytest.mark.parametrize("caller", ["asg_scores_no_grad", "asgloss_eval"])
def test_score_only_calls_take_the_warp_route(monkeypatch, caller):
    """The score-only per-lattice call, as ``asg_scores(impl='pallas')``
    under ``no_grad`` or as ``ASGLoss(impl='pallas')`` in eval mode, launches
    K7 once, on the warp route ('auto' at S <= 128)."""
    launched = _recording_launches(monkeypatch)
    trans, inputs, targets, li, lo = _letter_call()
    if caller == "asg_scores_no_grad":
        with torch.no_grad():
            _, aligned = pt.asg_scores(trans, inputs, targets, li, lo, impl="pallas")
        assert aligned[0] == -np.inf and torch.isfinite(aligned[1])
    else:
        crit = pt.ASGLoss(30, reduction="none", impl="pallas", device="cpu",
                          dtype=torch.float64).eval()
        with torch.no_grad():
            crit.transition.copy_(trans)
        loss = crit(inputs.clone().requires_grad_(True), targets, li, lo)
        assert torch.isfinite(loss[1]) and not loss.requires_grad
    assert launched == ["warp"]


def test_training_call_takes_the_warp_route_for_k7(monkeypatch):
    """A differentiated ``impl='pallas'`` call at a letter width launches K7
    once, on the warp route; K6 and K8 run their plain versions."""
    launched = _recording_launches(monkeypatch)
    monkeypatch.setattr(pfac, "fac_alpha_pallas", pfac.fac_alpha_plain)
    monkeypatch.setattr(pfac, "fac_bwd_pallas",
                        lambda lat, alpha, beta, g: pfac.fac_bwd_plain(lat, alpha, beta, g))
    trans, inputs, targets, li, lo = _letter_call()
    lo = torch.tensor([38, 7])
    em = inputs.clone().requires_grad_(True)
    loss = pt.asg_loss(trans, em, targets, li, lo, impl="pallas")
    loss.backward()
    assert launched == ["warp"]
    assert torch.isfinite(em.grad).all()
