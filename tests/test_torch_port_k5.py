"""K5's warp route in torch (``_fcc_bwd_split_plain``: the posteriors and
the transition partials per chunk of frames, then the fixed-order sums)
against K5's plain version ``fcc_bwd_plain`` and against the JAX package's
Pallas backward kernel (interpret mode), and the rule, checks and counts of
K5's two routes.

Inputs are made with numpy from a seed; everything runs at fp64 on CPU
tensors.  Tolerance: rtol 1e-9 and atol 1e-12 x the output's largest
magnitude (the same arithmetic, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_asg_tpu.ops.pallas import fcc_kernels as jfcc
from torch_asg_tpu_torch.ops.kernels import common as kcommon
from torch_asg_tpu_torch.ops.kernels import fcc_kernels as pfcc
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES

RTOL, ATOL_REL = 1e-9, 1e-12


def _case(seed, t_total, num_batches, num_labels, li=None, neg_inf=False):
    """Seeded numpy inputs (transition, emissions, lengths, g); ``li`` None
    draws ragged lengths in [T/2, T]; ``neg_inf`` forbids about 30% of the
    transitions."""
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    if neg_inf:
        trans[rng.random((num_labels, num_labels)) < 0.3] = -np.inf
    if li is None:
        li = rng.integers(max(1, t_total // 2), t_total + 1, size=num_batches)
    g = rng.uniform(0.5, 1.5, size=num_batches)
    return trans, inputs, np.asarray(li, np.int32), g


def _port_args(trans, inputs, li, g):
    """K5's arguments in the port, on the chains of K3's plain version."""
    e, c, x, li_t = pfcc._prepare(*[torch.from_numpy(np.asarray(a)) for a in (trans, inputs, li)])
    alpha, beta = pfcc.fcc_fwd_plain(e, c, x, li_t)
    return e, c, x, li_t, alpha, beta, torch.from_numpy(g)


def _assert_near(got, want, label):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30), err_msg=label)


@pytest.mark.parametrize("name, shape, li, chunk, neg_inf", [
    ("chunk_1", (9, 3, 5), None, 1, False),
    ("chunk_divides_l", (12, 3, 5), [12, 8, 4], 4, False),
    ("chunk_not_dividing", (11, 4, 6), None, 3, False),
    ("chunk_past_t", (7, 3, 4), None, 20, False),
    ("lengths_0_1_t_t_plus_1", (8, 5, 5), [0, 1, 8, 9, 8], 3, False),
    ("neg_inf_transitions", (10, 3, 6), None, 4, True),
    ("default_chunk_width_edge", (6, 2, 33), [6, 3], None, False),
])
def test_split_plain_matches_bwd_plain(name, shape, li, chunk, neg_inf):
    t_total, num_batches, num_labels = shape
    args = _port_args(*_case(31, t_total, num_batches, num_labels, li, neg_inf))
    want = pfcc.fcc_bwd_plain(*args)
    got = pfcc._fcc_bwd_split_plain(*args, chunk=chunk)
    for label, g, w in zip(("dI", "dT"), got, want):
        assert torch.isfinite(g).all(), f"{name} {label}: non-finite"
        _assert_near(g.numpy(), w.numpy(), f"{name} {label}")
    li_t = args[3].long()
    no_path = (li_t < 1) | (li_t > t_total)
    dead = (torch.arange(t_total)[:, None] >= li_t[None, :]) | no_path[None, :]
    assert (got[0][dead] == 0).all(), f"{name}: dI rows past L_in, or of no-path elements, must be 0"


@pytest.mark.parametrize("li, chunk, neg_inf", [(None, 3, False), ([1, 11, 6], 4, False),
                                                (None, 5, True)])
def test_split_plain_matches_jax_kernel(li, chunk, neg_inf):
    """The warp route's algorithm against the Pallas backward kernel it
    replaces, on the JAX kernel's own chains."""
    trans, inputs, li, g = _case(17, 11, 3, 6, li, neg_inf)
    t_total, num_batches, num_labels = inputs.shape
    inputs_p, li_col, c, e, e_t, dims = jfcc._prepare(
        *[jnp.asarray(a) for a in (trans, inputs, li)])
    alpha, beta = jfcc._run_fwd(c, li_col, e, e_t, inputs_p)
    g_col = jnp.pad(jnp.asarray(g), (0, dims[3] - num_batches))[:, None]
    gi, gt = jfcc._run_bwd(c, li_col, g_col, e_t, inputs_p, alpha, beta)

    def cut(x):
        return torch.from_numpy(np.array(x)[:t_total, :num_batches, :num_labels])

    p_e, p_c, p_x, p_li = pfcc._prepare(*[torch.from_numpy(np.asarray(a))
                                          for a in (trans, inputs, li)])
    got = pfcc._fcc_bwd_split_plain(p_e, p_c, p_x, p_li, cut(alpha), cut(beta),
                                    torch.from_numpy(g), chunk=chunk)
    _assert_near(got[0].numpy(), np.asarray(gi)[:t_total, :num_batches, :num_labels], "dI")
    _assert_near(got[1].numpy(), np.asarray(gt)[:num_labels, :num_labels], "dT")


@pytest.mark.parametrize("num_labels, route", [
    (1, "warp"), (30, "warp"), (32, "warp"), (33, "warp"), (128, "warp"),
    (129, "block"), (512, "block"),
])
def test_fcc_route_rule(num_labels, route):
    assert kcommon.width_route(num_labels) == route


def _k5_args(num_labels, seed=11):
    return _port_args(*_case(seed, 6, 2, num_labels))


def _recording_launches(monkeypatch):
    """Make every tensor take the kernel path, replace K5's launch by one
    that records its route and copies ``fcc_bwd_plain``'s outputs into the
    wrapper's."""
    launched = []

    def launch(route, e, c, inputs, li, alpha, beta, g, outs):
        launched.append(route)
        for out, w in zip(outs, pfcc.fcc_bwd_plain(e, c, inputs, li, alpha, beta, g)):
            out.copy_(w)

    monkeypatch.setattr(pfcc, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(pfcc, "_launch_bwd", launch)
    return launched


def test_bad_k5_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfcc.fcc_bwd_pallas
    with pytest.raises(ValueError, match="unknown K5 route"):
        fn(*_k5_args(5), route="grid")
    with pytest.raises(ValueError, match="K5's warp route"):
        fn(*_k5_args(129), route="warp")
    assert launched == [] and not LAUNCHES


def test_k5_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the
    wrapper hands back what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pfcc.fcc_bwd_pallas
    narrow, wide = _k5_args(30), _k5_args(130)
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K5": 3, "K5.warp": 1, "K5.block": 2}
    for g, w in zip(got, pfcc.fcc_bwd_plain(*narrow)):
        assert torch.equal(g, w)
