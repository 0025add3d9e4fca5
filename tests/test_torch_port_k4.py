"""K4's warp route in torch (``_fcc_beta_warp_plain``: K3's exp-domain beta
chain alone, with a per-step rescale, raw rows and per-frame offsets, then
the pass that takes their logs) against K4's plain version
``fcc_beta_plain`` (log domain) and against the JAX package's Pallas beta
kernel (interpret mode), and the rule, checks and counts of K4's two
routes.

Inputs are made with numpy from a seed; everything runs at fp64 on CPU
tensors.  Tolerance: rtol 1e-9 and atol 1e-12 x the output's largest
finite magnitude (the same recursion in another domain, exact to
rounding); the -inf entries must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops.pallas import fcc_kernels as jfcc
from torch_asg_tpu_torch.ops.kernels import common as kcommon
from torch_asg_tpu_torch.ops.kernels import fcc_kernels as pfcc
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES

RTOL, ATOL_REL = 1e-9, 1e-12


def _case(seed, t_total, num_batches, num_labels, li=None, neg_inf=False):
    """Seeded numpy inputs (transition, emissions, lengths); ``li`` None
    draws ragged lengths in [T/2, T]; ``neg_inf`` forbids about 30% of the
    transitions."""
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    if neg_inf:
        trans[rng.random((num_labels, num_labels)) < 0.3] = -np.inf
    if li is None:
        li = rng.integers(max(1, t_total // 2), t_total + 1, size=num_batches)
    return trans, inputs, np.asarray(li, np.int32)


def _port_args(trans, inputs, li):
    return pfcc._prepare(*[torch.from_numpy(np.asarray(a)) for a in (trans, inputs, li)])


def _assert_near(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=f"{label}: finite entries")
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=f"{label}: infinities")
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30), err_msg=label)


@pytest.mark.parametrize("name, shape, li, neg_inf", [
    ("ragged", (11, 4, 6), None, False),
    ("full_length", (9, 3, 5), [9, 9, 9], False),
    ("lengths_0_1_t_t_plus_1", (8, 5, 5), [0, 1, 8, 9, 8], False),
    ("neg_inf_transitions", (12, 3, 6), None, True),
    ("width_edge", (6, 2, 33), [6, 3], False),
])
def test_warp_plain_matches_beta_plain(name, shape, li, neg_inf):
    t_total, num_batches, num_labels = shape
    args = _port_args(*_case(43, t_total, num_batches, num_labels, li, neg_inf))
    want = pfcc.fcc_beta_plain(*args)
    got = pfcc._fcc_beta_warp_plain(*args)
    assert not torch.isnan(got).any(), f"{name}: NaN"
    _assert_near(got.numpy(), want.numpy(), name)
    if name == "lengths_0_1_t_t_plus_1":
        # L = 0 and L = T + 1 have no beta; L = 1 is the seed row alone
        assert (got[:, [0, 3]] == -np.inf).all()
        assert (got[0, 1] == 0).all() and (got[1:, 1] == -np.inf).all()
        assert torch.isfinite(got[:, 2]).all()


@pytest.mark.parametrize("li, neg_inf", [(None, False), ([1, 11, 6], False), (None, True)])
def test_warp_plain_matches_jax_kernel(li, neg_inf):
    """The warp route's chain against the Pallas beta kernel it replaces."""
    trans, inputs, li = _case(29, 11, 3, 6, li, neg_inf)
    t_total, num_batches, num_labels = inputs.shape
    inputs_p, li_col, c, e, _, _ = jfcc._prepare(*[jnp.asarray(a) for a in (trans, inputs, li)])
    want = jfcc._run_beta(c, li_col, e, inputs_p)
    got = pfcc._fcc_beta_warp_plain(*_port_args(trans, inputs, li))
    _assert_near(got.numpy(), np.asarray(want)[:t_total, :num_batches, :num_labels], "beta")


def test_warp_plain_score_matches_the_block_route():
    """The score-only call's score lse(beta_0 + I_0) from the warp route's
    chain equals the block route's."""
    args = _port_args(*_case(7, 10, 4, 5, [10, 3, 1, 7]))
    x = args[2]
    got = pfcc._score(pfcc._fcc_beta_warp_plain(*args)[0], x[0])
    want = pfcc._score(pfcc.fcc_beta_plain(*args)[0], x[0])
    assert torch.isfinite(got).all()
    _assert_near(got.numpy(), want.numpy(), "score")


@pytest.mark.parametrize("num_labels, route", [
    (1, "warp"), (128, "warp"), (129, "block"), (512, "block"),
])
def test_k4_route_rule(num_labels, route):
    assert kcommon.width_route(num_labels) == route


def _recording_launches(monkeypatch):
    """Make every tensor of the FCC module take the kernel path, replace
    K4's launch by one that records its route and copies ``fcc_beta_plain``'s
    output into the wrapper's."""
    launched = []

    def launch(route, e, c, inputs, li, beta):
        launched.append(route)
        beta.copy_(pfcc.fcc_beta_plain(e, c, inputs, li))

    monkeypatch.setattr(pfcc, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pfcc, "_launch_beta", launch)
    return launched


def _k4_args(num_labels, seed=3):
    return _port_args(*_case(seed, 6, 2, num_labels))


def test_bad_k4_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfcc.fcc_beta_pallas
    with pytest.raises(ValueError, match="unknown K4 route"):
        fn(*_k4_args(5), route="lane")
    with pytest.raises(ValueError, match="K4's warp route"):
        fn(*_k4_args(129), route="warp")
    assert launched == [] and not LAUNCHES


def test_k4_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the wrapper hands back
    what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfcc.fcc_beta_pallas
    narrow, wide = _k4_args(30), _k4_args(130)
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K4": 3, "K4.warp": 1, "K4.block": 2}
    assert torch.equal(got, pfcc.fcc_beta_plain(*narrow))


def _letter_call(seed=23):
    """Letter-width inputs (N = 30 labels, S = 50 target slots, T = 60
    frames: the front-end cuts S to T), fp64."""
    trans, inputs, li = _case(seed, 60, 2, 30, li=[60, 41])
    rng = np.random.default_rng(seed)
    targets = torch.from_numpy(rng.integers(0, 30, size=(2, 50)))
    lo = torch.tensor([50, 7])
    return torch.tensor(trans), torch.tensor(inputs), targets, torch.from_numpy(li), lo


@pytest.mark.parametrize("caller", ["asg_scores_no_grad", "asgloss_eval"])
def test_score_only_calls_take_the_warp_route(monkeypatch, caller):
    """The score-only per-lattice call, as ``asg_scores(impl='pallas')``
    under ``no_grad`` or as ``ASGLoss(impl='pallas')`` in eval mode, launches
    K4 once, on the warp route ('auto' at N <= 128)."""
    launched = _recording_launches(monkeypatch)
    trans, inputs, targets, li, lo = _letter_call()
    if caller == "asg_scores_no_grad":
        with torch.no_grad():
            full, _ = pt.asg_scores(trans, inputs, targets, li, lo, impl="pallas")
        assert torch.isfinite(full).all()
    else:
        crit = pt.ASGLoss(30, impl="pallas", device="cpu", dtype=torch.float64).eval()
        with torch.no_grad():
            crit.transition.copy_(trans)
        loss = crit(inputs.clone().requires_grad_(True), targets, li, lo)
        assert torch.isfinite(loss).all() and not loss.requires_grad
    assert launched == ["warp"]
