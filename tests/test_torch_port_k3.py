"""K3's warp route in torch (``_fcc_fwd_warp_plain``: exp-domain alpha and
beta chains with a per-step rescale, raw rows and per-frame offsets, then
the pass that takes their logs) against K3's plain version
``fcc_fwd_plain`` (log domain) and against the JAX package's Pallas
forward kernel (interpret mode), and the rule, checks and counts of K3's
two routes.

Inputs are made with numpy from a seed; everything runs at fp64 on CPU
tensors.  Tolerance: rtol 1e-9 and atol 1e-12 x the output's largest
finite magnitude (the same recursions in another domain, exact to
rounding); the -inf entries must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops.pallas import fcc_kernels as jfcc
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
def test_warp_plain_matches_fwd_plain(name, shape, li, neg_inf):
    t_total, num_batches, num_labels = shape
    args = _port_args(*_case(41, t_total, num_batches, num_labels, li, neg_inf))
    want = pfcc.fcc_fwd_plain(*args)
    got = pfcc._fcc_fwd_warp_plain(*args)
    for label, g, w in zip(("alpha", "beta"), got, want):
        assert not torch.isnan(g).any(), f"{name} {label}: NaN"
        _assert_near(g.numpy(), w.numpy(), f"{name} {label}")
    if name == "lengths_0_1_t_t_plus_1":
        alpha, beta = got
        assert (alpha[:, 0] == -np.inf).all() and (beta[:, [0, 3]] == -np.inf).all()
        assert torch.isfinite(alpha[:, 3]).all() and (beta[0, 1] == 0).all()


@pytest.mark.parametrize("li, neg_inf", [(None, False), ([1, 11, 6], False), (None, True)])
def test_warp_plain_matches_jax_kernel(li, neg_inf):
    """The warp route's chains against the Pallas forward kernel they
    replace."""
    trans, inputs, li = _case(19, 11, 3, 6, li, neg_inf)
    t_total, num_batches, num_labels = inputs.shape
    inputs_p, li_col, c, e, e_t, _ = jfcc._prepare(*[jnp.asarray(a) for a in (trans, inputs, li)])
    want = jfcc._run_fwd(c, li_col, e, e_t, inputs_p)
    got = pfcc._fcc_fwd_warp_plain(*_port_args(trans, inputs, li))
    for label, g, w in zip(("alpha", "beta"), got, want):
        _assert_near(g.numpy(), np.asarray(w)[:t_total, :num_batches, :num_labels], label)


def test_warp_plain_scores_and_posteriors_match_the_block_route():
    """Through the tier's own formulas: the score lse(beta_0 + I_0) and the
    posteriors softmax(alpha + beta) from the warp route's chains equal the
    block route's."""
    args = _port_args(*_case(7, 10, 4, 5))
    x = args[2]
    a, b = pfcc._fcc_fwd_warp_plain(*args)
    a2, b2 = pfcc.fcc_fwd_plain(*args)
    _assert_near(pfcc._score(b[0], x[0]).numpy(), pfcc._score(b2[0], x[0]).numpy(), "score")
    _assert_near(torch.softmax(a + b, dim=2).nan_to_num().numpy(),
                 torch.softmax(a2 + b2, dim=2).nan_to_num().numpy(), "posteriors")


def _recording_launches(monkeypatch):
    """Make every tensor take the kernel path, replace K3's launch by one
    that records its route and copies ``fcc_fwd_plain``'s outputs into the
    wrapper's."""
    launched = []

    def launch(route, e, c, inputs, li, outs):
        launched.append(route)
        for out, w in zip(outs, pfcc.fcc_fwd_plain(e, c, inputs, li)):
            out.copy_(w)

    monkeypatch.setattr(pfcc, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pfcc, "_launch_fwd", launch)
    return launched


def _k3_args(num_labels, seed=3):
    return _port_args(*_case(seed, 6, 2, num_labels))


def test_bad_k3_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfcc.fcc_fwd_pallas
    with pytest.raises(ValueError, match="unknown K3 route"):
        fn(*_k3_args(5), route="lane")
    with pytest.raises(ValueError, match="K3's warp route"):
        fn(*_k3_args(129), route="warp")
    assert launched == [] and not LAUNCHES


def test_k3_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the wrapper hands back
    what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfcc.fcc_fwd_pallas
    narrow, wide = _k3_args(30), _k3_args(130)
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K3": 3, "K3.warp": 1, "K3.block": 2}
    for g, w in zip(got, pfcc.fcc_fwd_plain(*narrow)):
        assert torch.equal(g, w)


def test_pallas_tier_takes_the_warp_route_for_both_kernels(monkeypatch):
    """A differentiated ``impl='pallas'`` call at a letter width launches K3
    and K5 once each, both on the warp route ('auto' at N <= 128)."""
    fwd = _recording_launches(monkeypatch)
    bwd = []

    def launch_bwd(route, e, c, inputs, li, alpha, beta, g, outs):
        bwd.append(route)
        for out, w in zip(outs, pfcc.fcc_bwd_plain(e, c, inputs, li, alpha, beta, g)):
            out.copy_(w)

    monkeypatch.setattr(pfcc, "_launch_bwd", launch_bwd)
    trans, inputs, li = _case(23, 9, 2, 30)
    rng = np.random.default_rng(23)
    targets = torch.from_numpy(rng.integers(0, 30, size=(2, 3)))
    lo = torch.tensor([3, 2])
    em = torch.tensor(inputs, requires_grad=True)
    loss = pt.asg_loss(torch.tensor(trans), em, targets, torch.from_numpy(li), lo, impl="pallas")
    loss.backward()
    assert fwd == ["warp"] and bwd == ["warp"]
    assert torch.isfinite(em.grad).all()
