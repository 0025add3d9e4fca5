"""K8's warp route in torch (``_fac_bwd_split_plain``: the aligned
posteriors and the edge-term partials per chunk of frames, then the
fixed-order sums) against K8's plain version ``fac_bwd_plain`` and against
the JAX package's Pallas FAC backward kernel (interpret mode), and the rule,
checks and counts of K8's two routes.

Inputs are made with numpy from a seed; everything runs at fp64 on CPU
tensors.  Tolerance: rtol 1e-9 and atol 1e-12 x the output's largest
magnitude (the same arithmetic, summed in another order).
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


def _case(seed, t_total, num_batches, s_total, li=None, lo=None, neg_inf=False):
    """Seeded numpy inputs (transition, emissions, targets, lengths, g);
    ``li`` None draws ragged input lengths in [T/2, T], ``lo`` None target
    lengths in [1, S]; ``neg_inf`` forbids about 30% of the transitions."""
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, NUM_LABELS))
    trans = rng.normal(size=(NUM_LABELS, NUM_LABELS)) * 0.5
    if neg_inf:
        trans[rng.random((NUM_LABELS, NUM_LABELS)) < 0.3] = -np.inf
    targets = rng.integers(0, NUM_LABELS, size=(num_batches, s_total))
    if li is None:
        li = rng.integers(max(1, t_total // 2), t_total + 1, size=num_batches)
    if lo is None:
        lo = rng.integers(1, s_total + 1, size=num_batches)
    g = rng.uniform(0.5, 1.5, size=num_batches)
    return (trans, inputs, targets.astype(np.int32), np.asarray(li, np.int32),
            np.asarray(lo, np.int32), g)


def _port_args(trans, inputs, targets, li, lo, g):
    """K8's arguments in the port, on the chains of K6's and K7's plain
    versions."""
    trans, inputs, targets, li, lo, g = map(torch.from_numpy, (trans, inputs, targets, li,
                                                               lo, g))
    lat = make_aligned(trans, inputs, targets, li, lo)
    return lat, pfac.fac_alpha_plain(lat), pfac.fac_beta_plain(lat, li, lo), g


def _assert_near(got, want, label):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30), err_msg=label)


@pytest.mark.parametrize("name, shape, li, lo, chunk, neg_inf", [
    ("chunk_1", (9, 3, 5), None, None, 1, False),
    ("chunk_divides_t", (12, 3, 5), [12, 8, 4], None, 4, False),
    ("chunk_not_dividing", (11, 4, 6), None, None, 3, False),
    ("chunk_past_t", (7, 3, 4), None, None, 20, False),
    ("lengths_0_1_t_t_plus_1", (8, 4, 5), [0, 1, 8, 9], [1, 1, 5, 3], 3, False),
    ("neg_inf_transitions", (10, 3, 6), None, None, 4, True),
    ("default_chunk_width_edge", (40, 2, 33), [40, 35], [33, 20], None, False),
])
def test_split_plain_matches_bwd_plain(name, shape, li, lo, chunk, neg_inf):
    t_total, num_batches, s_total = shape
    args = _port_args(*_case(31, t_total, num_batches, s_total, li, lo, neg_inf))
    want = pfac.fac_bwd_plain(*args)
    got = pfac._fac_bwd_split_plain(*args, chunk=chunk)
    for label, g, w in zip(("dA", "gself", "gnext"), got, want):
        assert torch.isfinite(g).all(), f"{name} {label}: non-finite"
        _assert_near(g.numpy(), w.numpy(), f"{name} {label}")
    assert (got[2][:, -1] == 0).all(), f"{name}: gnext's last slot must be 0"


@pytest.mark.parametrize("li, chunk, neg_inf", [(None, 3, False), ([1, 11, 6], 4, False),
                                                (None, 5, True)])
def test_split_plain_matches_jax_kernel(li, chunk, neg_inf):
    """The warp route's algorithm against the Pallas FAC backward kernel it
    replaces, on the JAX kernels' own chains."""
    trans, inputs, targets, li, lo, g = _case(17, 11, 3, 5, li, None, neg_inf)
    t_total, num_batches, _ = inputs.shape
    s_total = targets.shape[1]
    _, ali_p, self_t, next_t, li_c, lo_c, fdims = jfac._prepare(
        *[jnp.asarray(a) for a in (trans, inputs, targets, li, lo)])
    f_alpha = jfac._fac_alpha_pass(self_t, next_t, ali_p)
    f_beta = jfac._fac_beta_pass(li_c, lo_c, self_t, next_t, ali_p)
    g_col = jnp.pad(jnp.asarray(g), (0, fdims[3] - num_batches))[:, None]
    want = jfac._fac_bwd_pass(g_col, self_t, next_t, ali_p, f_alpha, f_beta)

    def cut(x):
        return torch.from_numpy(np.array(x)[:, :num_batches, :s_total])

    lat = make_aligned(*map(torch.from_numpy, (trans, inputs, targets, li, lo)))
    got = pfac._fac_bwd_split_plain(lat, cut(f_alpha), cut(f_beta), torch.from_numpy(g),
                                    chunk=chunk)
    _assert_near(got[0].numpy(), np.asarray(want[0])[:, :num_batches, :s_total], "dA")
    for label, q, w in zip(("gself", "gnext"), got[1:], want[1:]):
        _assert_near(q.numpy(), np.asarray(w)[:num_batches, :s_total], label)


@pytest.mark.parametrize("s_total, route", [
    (1, "warp"), (50, "warp"), (128, "warp"), (129, "block"), (512, "block"),
])
def test_fac_route_rule(s_total, route):
    assert kcommon.width_route(s_total) == route


def _k8_args(s_total, seed=11):
    return _port_args(*_case(seed, 6, 2, s_total))


def _recording_launches(monkeypatch):
    """Make every tensor take the kernel path, replace K8's launch by one
    that records its route and copies ``fac_bwd_plain``'s outputs into the
    wrapper's."""
    launched = []

    def launch(route, lat, alpha, beta, g, outs):
        launched.append(route)
        for out, w in zip(outs, pfac.fac_bwd_plain(lat, alpha, beta, g)):
            out.copy_(w)

    monkeypatch.setattr(pfac, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pfac, "_launch_bwd", launch)
    return launched


def test_bad_k8_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfac.fac_bwd_pallas
    with pytest.raises(ValueError, match="unknown K8 route"):
        fn(*_k8_args(5), route="grid")
    with pytest.raises(ValueError, match="K8's warp route"):
        fn(*_k8_args(129), route="warp")
    assert launched == [] and not LAUNCHES


def test_k8_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the
    wrapper hands back what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfac.fac_bwd_pallas
    narrow, wide = _k8_args(50), _k8_args(130)
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K8": 3, "K8.warp": 1, "K8.block": 2}
    for g, w in zip(got, pfac.fac_bwd_plain(*narrow)):
        assert torch.equal(g, w)


def test_pallas_tier_takes_the_warp_route_for_k8(monkeypatch):
    """A differentiated ``impl='pallas'`` call at a letter width launches K8
    once, on the warp route ('auto' at S <= 128); K6 and K7 run their plain
    versions."""
    launched = _recording_launches(monkeypatch)
    monkeypatch.setattr(pfac, "fac_alpha_pallas", pfac.fac_alpha_plain)
    monkeypatch.setattr(pfac, "fac_beta_pallas", pfac.fac_beta_plain)
    trans, inputs, targets, li, lo, _ = _case(23, 9, 2, 7, lo=[7, 4])
    em = torch.tensor(inputs, requires_grad=True)
    loss = pt.asg_loss(torch.tensor(trans), em, torch.from_numpy(targets),
                       torch.from_numpy(li), torch.from_numpy(lo), impl="pallas")
    loss.backward()
    assert launched == ["warp"]
    assert torch.isfinite(em.grad).all()
