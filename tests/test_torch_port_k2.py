"""K2's warp route in torch (``_bwd_split_plain``: the alpha chains' rows,
then the posteriors per chunk of frames, then the fixed-order sums) against
K2's plain version ``_bwd_plain`` and against the JAX package's Pallas
backward kernel (interpret mode), and the rule, checks and counts of K2's
two routes.

Inputs are made with numpy from a seed; everything runs at fp64 on CPU
tensors.  Tolerance: rtol 1e-9 and atol 1e-12 x the output's largest
magnitude, the bound ``chip_smoke.py`` holds K2 to in fp64 (the same
arithmetic, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_asg_tpu.ops.pallas import asg_kernels as jkern
from torch_asg_tpu_torch.ops.kernels import asg_kernels as pkern
from torch_asg_tpu_torch.ops.kernels import common as kcommon
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES

RTOL, ATOL_REL = 1e-9, 1e-12
OUTPUTS = ("gI", "gA", "dT", "gself", "gnext")


def _case(seed, t_total, num_batches, s_total, num_labels, li=None):
    """Seeded numpy inputs; ``li`` None draws ragged lengths in
    [max(S, T/2), T]."""
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    if li is None:
        li = rng.integers(max(s_total, t_total // 2), t_total + 1, size=num_batches)
    lo = rng.integers(1, s_total + 1, size=num_batches)
    g_full = rng.uniform(0.5, 1.5, size=num_batches)
    g_fac = -rng.uniform(0.5, 1.5, size=num_batches)
    return (trans, inputs, targets, np.asarray(li, np.int32), lo.astype(np.int32), g_full,
            g_fac)


def _port_args(trans, inputs, targets, li, lo, g_full, g_fac):
    """K2's arguments in the port, on the residuals of K1's plain version."""
    t = [torch.from_numpy(np.asarray(a)) for a in (trans, inputs, targets, li, lo)]
    lat, e, _ = pkern._prepare(*t)
    k1 = (e, lat.self_trans.contiguous(), lat.next_trans.contiguous(), t[1],
          lat.inputs.contiguous(), t[3], t[4])
    pb, qb, _, _ = pkern._fwd_store_plain(*k1)
    return k1[:6] + (pb, qb, torch.from_numpy(g_full), torch.from_numpy(g_fac))


def _assert_near(got, want, label):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30), err_msg=label)


@pytest.mark.parametrize("name, shape, li, chunk", [
    ("ragged_chunk_not_dividing_t", (11, 4, 4, 6), None, 4),
    ("lengths_1_and_t", (9, 4, 3, 5), [1, 9, 9, 1], 2),
    ("lengths_outside_range", (10, 5, 4, 5), [0, 11, 10, -1, 4], None),
    ("one_frame_chunks", (7, 3, 3, 4), None, 1),
    ("one_chunk_past_t", (7, 3, 3, 4), None, 12),
    ("width_edges", (6, 2, 33, 40), [6, 3], 5),
])
def test_split_plain_matches_bwd_plain(name, shape, li, chunk):
    t_total, num_batches, s_total, num_labels = shape
    args = _port_args(*_case(21, t_total, num_batches, s_total, num_labels, li))
    want = pkern._bwd_plain(*args)
    got = pkern._bwd_split_plain(*args, chunk=chunk)
    for label, g, w in zip(OUTPUTS, got, want):
        assert torch.isfinite(g).all(), f"{name} {label}: non-finite"
        _assert_near(g.numpy(), w.numpy(), f"{name} {label}")
    li_t = args[5]
    dead = torch.arange(t_total)[:, None] >= li_t[None, :]
    for g in got[:2]:
        assert (g[dead] == 0).all(), f"{name}: rows t >= L_in must stay zero"
    if name == "lengths_outside_range":
        no_path = [0, 1, 3]  # L_in = 0, T + 1, -1
        for g in (got[0], got[1]):
            assert (g[:, no_path] == 0).all()
        for g in (got[3], got[4]):
            assert (g[no_path] == 0).all()


@pytest.mark.parametrize("li, chunk", [(None, 3), ([1, 11, 6], 4)])
def test_split_plain_matches_jax_kernel(li, chunk):
    """The warp route's algorithm against the Pallas backward kernel it
    replaces, on the same residuals (as test_torch_port_grads.py holds
    ``_bwd_plain`` against it)."""
    trans, inputs, targets, li, lo, g_full, g_fac = _case(13, 11, 3, 4, 6, li)
    (_, ip, ap, e, e_t, self_p, next_p, li_col, lo_col, _, dims) = jkern._prepare(
        *[jnp.asarray(a) for a in (trans, inputs, targets, li, lo)])
    t_total, num_batches, num_labels, s_total, b_pad, n_pad, s_pad = dims
    pb, qb, _, _ = jkern._run_fwd(li_col, lo_col, e, self_p, next_p, ip, ap,
                                  (num_labels, n_pad, s_pad), store=True)
    gcol = [jkern.pad_axis(jnp.asarray(g), b_pad, 0, 0.0)[:, None] for g in (g_full, g_fac)]
    want = jkern._run_bwd(li_col, *gcol, e, e_t, self_p, next_p, ip, ap, pb, qb,
                          (num_labels, n_pad, s_pad))
    want = [np.asarray(want[0])[:t_total, :num_batches, :num_labels],
            np.asarray(want[1])[:t_total, :num_batches, :s_total],
            np.asarray(want[2])[:num_labels, :num_labels],
            np.asarray(want[3])[:num_batches, :s_total],
            np.asarray(want[4])[:num_batches, :s_total]]
    got = pkern._bwd_split_plain(*_port_args(trans, inputs, targets, li, lo, g_full, g_fac),
                                 chunk=chunk)
    for label, g, w in zip(OUTPUTS, got, want):
        _assert_near(g.numpy(), w, label)


def test_alpha_rows_match_the_block_routes_chain():
    """Phase 1's exp-domain rows give the block route's alpha: log s_t + I_t
    differs from ``_bwd_plain``'s lpa by a per-row constant, so the
    rescaled rows agree."""
    args = _port_args(*_case(5, 8, 2, 3, 5, [8, 8]))
    e, self_t, next_t, inputs, aligned = args[:5]
    s_rows, qa_rows = pkern._alpha_rows(e, self_t, next_t, inputs, aligned)
    lpa = torch.log(s_rows) + inputs
    pa = torch.exp(lpa - lpa.amax(dim=2, keepdim=True))
    # the block route's chain, written out: s = pa_{t-1} @ E^T from its own rows
    for t in range(1, 8):
        s = pa[t - 1] @ e.T
        ref = torch.log(s) + inputs[t]
        ref = torch.exp(ref - ref.amax(dim=1, keepdim=True))
        _assert_near(pa[t].numpy(), ref.numpy(), f"pa row {t}")
    assert torch.isfinite(qa_rows[:, :, 0]).all() and (qa_rows[0, :, 1:] == -np.inf).all()


@pytest.mark.parametrize("num_labels, s_total, route", [
    (30, 50, "warp"), (32, 32, "warp"), (64, 65, "warp"), (128, 128, "warp"),
    (129, 10, "block"), (10, 129, "block"), (512, 512, "block"),
])
def test_bwd_route_rule(num_labels, s_total, route):
    assert kcommon.width_route(max(num_labels, s_total)) == route


def _k2_args(num_labels, s_total, seed=11):
    return _port_args(*_case(seed, max(6, s_total), 2, s_total, num_labels))


def _recording_launches(monkeypatch):
    """Replace K2's launch by one that records its route and copies
    ``_bwd_plain``'s outputs into the wrapper's."""
    launched = []

    def launch(route, e, self_t, next_t, inputs, aligned, li, pb, qb, g_full, g_fac, outs):
        launched.append(route)
        want = pkern._bwd_plain(e, self_t, next_t, inputs, aligned, li, pb, qb, g_full, g_fac)
        for out, w in zip(outs, want):
            out.copy_(w)

    monkeypatch.setattr(pkern, "_launch_bwd", launch)
    return launched


def test_bad_bwd_route_raises_before_any_launch(monkeypatch):
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pkern._bwd_kernel
    with pytest.raises(ValueError, match="unknown K2 route"):
        fn(*_k2_args(5, 3), route="grid")
    with pytest.raises(ValueError, match="K2's warp route"):
        fn(*_k2_args(129, 3), route="warp")
    assert launched == [] and not LAUNCHES


def test_bwd_route_dispatch_and_counts(monkeypatch):
    """``route=None`` launches the route ``width_route`` names and counts it
    in the launch ledger by route, beside its total; the wrapper hands back
    what the launch wrote."""
    LAUNCHES.clear()
    launched = _recording_launches(monkeypatch)
    fn = pkern._bwd_kernel
    narrow, wide = _k2_args(30, 5), _k2_args(130, 5)
    got = fn(*narrow)
    fn(*wide)
    fn(*narrow, route="block")
    assert launched == ["warp", "block", "block"]
    assert LAUNCHES == {"K2": 3, "K2.warp": 1, "K2.block": 2}
    for g, w in zip(got, pkern._bwd_plain(*narrow)):
        assert torch.equal(g, w)
